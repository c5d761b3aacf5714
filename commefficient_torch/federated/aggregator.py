"""FedModel / FedOptimizer / LambdaLR: the port of
``commefficient_tpu/federated/aggregator.py``.

Call-surface parity with the reference: ``FedModel`` is callable like a
model; a train round returns ``[loss_array, acc_array, download_bytes,
upload_bytes]``, a val call ``[loss_array, acc_array]``; ``FedOptimizer``
exposes ``step()`` / ``get_lr()`` and is driven by ``LambdaLR``. A round is
``lr_scheduler.step(); model(batch); opt.step()``.

Byte accounting, both of the JAX package's regimes: upload is 4 B x the
transmitted size for each participating client (the gradient size for
``uncompressed``, ``true_topk`` and ``fedavg``, ``k`` for ``local_topk``,
the lane-aligned table for ``sketch``); download regime (a)
(single-epoch, whole-client batches) charges the popcount of an
updated-since-init mask, regime (b) charges each sampled client the count
of coordinates changed since it last participated, from a device-resident
per-coordinate last-changed round index, in the resident layout of the
weights (chunked in sketch mode, flat otherwise).

The round runs on one device, or over a client group
(``group``, a ``parallel/mesh.ClientGroup``: one process per GPU, the
device ``cuda:LOCAL_RANK``, every rank holding the replicated weights and
client state and running its slots of each round; ``--server_shard`` and
``--collective_plan`` pick the sharded server and its wire dtypes). On
the 2-D (clients x shard) grid (``--shard_devices``) the server reduces
over the ordered axes ``("shard", "clients")`` (``_server_axes``,
``_axis_sizes``; ``_n_shard`` is their product), and the plan is resolved
once before the round's steps are built (``_resolve_plan``): ``auto``
runs the probe over this config's leg geometries, a per-axis spec is
resolved against the grid (``_plan_lowering``). Only the group's rank 0
writes files.

Per-client state takes the tier the memory plan picks
(``federated/memory.py``, the JAX package's planner): ``hbm`` keeps the
rows on the model's device and the round indexes them; ``host`` keeps
them in CPU tensors (``host_state.RowStreamer``) and ``disk`` in the sparse
row files of ``host_state.MemmapRowStore`` (``--state_dir``, default
``<checkpoint_path>/client_state``; ``<state_dir>/rank<r>`` on each rank
of a client group, since every rank holds every row). In both the round
runs on a W-row proxy of the participating rows with ``client_ids :=
arange(W)``: ``begin_round`` takes the rows from the ``CohortPrefetcher``
(a hit when ``engine.cohort_lookahead`` asked for them while the previous
round ran), the straggler dispatch rides the same proxy, and
``_apply_server`` hands ``new_proxy - old`` to the tier's ordered worker;
an async buffered dispatch drops the proxy. Each round's ``offload``
record (tier, prefetch hit, gather and scatter times, the storage-fault
counters' deltas) rides its handle to the telemetry round line, and the
disk tier's ladder events become telemetry events at the next dispatch.
``finalize`` drains and joins the tier's worker; an I/O error surfaced
there fails the run. DP noise draws from a
``torch.Generator`` on the device, seeded with ``args.seed + 1`` as the
JAX package seeds its key; a JAX-only ``--rng_impl`` raises
(``config.reject_jax_prng``).

``begin_round`` dispatches a round without a host wait: the batch and the
participants' last rounds reach the card through pinned host buffers and
non-blocking copies (the handle keeps the buffers until the round is
drained), and the accounting's round index lives on the device. The
fetches go through ``profiling.materialize``: ``finish_rounds`` stacks the
metrics and download counts of several rounds and copies them once
(``federated/engine.PipelinedRoundEngine`` drains that way). The model
state is ResNet9's BatchNorm running statistics under ``--batchnorm``.

Under ``--guards`` and ``--telemetry`` the server step's verdict and
metric vector wait on the device until ``seal_round`` puts them on their
round's handle, and come back in the drain's one fetch; the drain then
gives each round, in dispatch order, to the run's recorder
(``telemetry.RunTelemetry``, attached as ``self.telemetry``) and to the
guard ladder (``_note_guard``: a trip is logged, a second consecutive one
restores the device-resident snapshot, ``--max_guard_trips`` raise), as
the JAX package does. ``--inject_fault ROUND:nan|inf`` writes the poison
into a round's transmit on the device.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from commefficient_torch.convert import flax_from_port
from commefficient_torch.federated.checkpoint import save_checkpoint
from commefficient_torch.federated.host_state import (
    CohortPrefetcher,
    MemmapRowStore,
    RowStreamer,
    parse_io_fault,
)
from commefficient_torch.federated.memory import (
    plan_client_state_memory,
    state_device,
)
from commefficient_torch.federated.participation import _f32, _transmit_sum
from commefficient_torch.federated.rounds import (
    ClientStates,
    RoundConfig,
    build_round_step,
    init_client_states,
)
from commefficient_torch.federated.server import (
    ServerConfig,
    init_server_state,
    leg_lowerings,
)
from commefficient_torch.federated.worker import WorkerConfig
from commefficient_torch.models.layers import torch_conv_init_
from commefficient_torch.ops.collectives import (
    DEFAULT_QUANT_BLOCK,
    autotune_collective_plan,
    leg_quantized,
    level_sr_generators,
    parse_collective_plan,
    plan_from_reduce_dtype,
    plan_lowering,
)
from commefficient_torch.ops.flat import ParamLayout
from commefficient_torch.ops.sketch import make_sketch
from commefficient_torch.parallel.mesh import (
    EXPERT_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
    STAGE_AXIS,
)
from commefficient_torch.profiling import annotate

DEFAULT_NUM_CLIENTS = {"EMNIST": 3500, "PERSONA": 17568}


def resolve_device(name) -> torch.device:
    """``cuda`` (the default) or ``cpu``. A CUDA request on a host without
    a usable card raises: the port never continues on the CPU."""
    dev = torch.device(name if name is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA requested but torch.cuda.is_available() is False; pass "
            "--device cpu (device='cpu') to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def init_model_(model: torch.nn.Module, seed) -> None:
    """Draw the model's initial weights from a generator seeded with
    ``seed``: the model's own ``init_`` (the JAX package's initializers),
    or PyTorch's default conv/linear init (ResNet9)."""
    gen = torch.Generator().manual_seed(int(seed))
    init_ = getattr(model, "init_", None)
    if init_ is not None:
        init_(gen)
    else:
        torch_conv_init_(model, gen)


def set_fp32_numerics() -> None:
    """The JAX reference computes in float32: turn TF32 off for cuDNN
    convolutions and cuBLAS matrix products."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


class RoundHandle(NamedTuple):
    """A dispatched round: device metrics and the deferred download
    count; ``valid``/``participating``/``upload`` are host data.
    ``round_no`` is the model's global dispatch index
    (``FedModel.rounds_dispatched`` when the round was dispatched).
    ``staged`` keeps the pinned host buffers of the round's host-to-device
    copies alive until the round is drained, and ``done`` is the CUDA event
    recorded after its server phase (``FedModel.seal_round``; None on the
    CPU). ``guard`` (``--guards``, the 0-dim bool verdict) and
    ``telemetry`` (``--telemetry``, the metric vector) are attached by
    ``seal_round`` and stay on the device until the drain.
    ``staleness``: rounds since each participant last joined (download
    regime (b) only; host data). ``cohort``: the participation layer's
    host record of the round (cohort target, drop / slow / corrupt counts,
    the retry ladder, late landings, the async record), merged into the
    telemetry ``cohort`` span at the drain; None without the layer.
    ``async_masked``: an async fold's device count of masked
    contributions, fetched with the drain (None elsewhere). ``offload``:
    the streamed tiers' host record of the round (the telemetry round
    line's ``offload`` span; None in the ``hbm`` tier)."""

    metrics: Tuple[Any, ...]
    valid: np.ndarray
    participating: np.ndarray
    download: Optional[Any]
    upload: np.ndarray
    round_no: int = -1
    staged: Tuple[Any, ...] = ()
    done: Optional[Any] = None
    guard: Optional[Any] = None
    telemetry: Optional[Any] = None
    staleness: Optional[np.ndarray] = None
    cohort: Optional[dict] = None
    async_masked: Optional[Any] = None
    offload: Optional[dict] = None


def worker_config_from_args(args, group=None) -> WorkerConfig:
    """The worker's config; its ``seq_axis``, ``model_axis``, ``pp_axis``
    and ``expert_axis`` come from the REALIZED grid (``group``): the grid
    policy may have reduced ``--seq_devices``, ``--model_devices``,
    ``--pipeline_devices`` or ``--expert_devices`` to 1, and a config
    naming an axis the grid lacks would fail in the round."""
    seq_axis = None
    if getattr(args, "seq_parallel", "none") != "none" and \
            group is not None and group.seq is not None:
        seq_axis = SEQ_AXIS
    model_axis = None
    if getattr(args, "model_devices", 1) > 1 and group is not None \
            and group.model is not None:
        model_axis = MODEL_AXIS
    pp_axis = None
    if getattr(args, "pipeline_devices", 1) > 1 and group is not None \
            and group.stage is not None:
        pp_axis = STAGE_AXIS
    expert_axis = None
    if getattr(args, "expert_devices", 1) > 1 and group is not None \
            and group.expert is not None:
        expert_axis = EXPERT_AXIS
    return WorkerConfig(
        mode=args.mode, error_type=args.error_type, k=args.k,
        num_workers=args.num_workers, weight_decay=args.weight_decay,
        local_momentum=args.local_momentum,
        microbatch_size=args.microbatch_size,
        max_grad_norm=args.max_grad_norm, do_dp=args.do_dp,
        dp_mode=args.dp_mode, l2_norm_clip=args.l2_norm_clip,
        noise_multiplier=args.noise_multiplier,
        num_fedavg_epochs=args.num_fedavg_epochs,
        fedavg_batch_size=args.fedavg_batch_size,
        fedavg_lr_decay=args.fedavg_lr_decay,
        do_topk_down=args.do_topk_down, seq_axis=seq_axis,
        model_axis=model_axis, expert_axis=expert_axis, pp_axis=pp_axis)


def server_config_from_args(args, grad_size: int) -> ServerConfig:
    return ServerConfig(
        mode=args.mode, error_type=args.error_type, k=args.k,
        grad_size=grad_size, virtual_momentum=args.virtual_momentum,
        local_momentum=args.local_momentum, do_dp=args.do_dp,
        dp_mode=args.dp_mode, noise_multiplier=args.noise_multiplier,
        fused_epilogue=bool(getattr(args, "fused_epilogue", False)))


def collective_plan_from_args(args):
    """``--collective_plan``, else the ``--reduce_dtype`` alias; None for
    ``auto``, which ``FedModel`` resolves by its probe."""
    spec = (getattr(args, "collective_plan", None) or "").strip()
    if spec == "auto":
        return None
    if spec:
        return parse_collective_plan(spec)
    return plan_from_reduce_dtype(getattr(args, "reduce_dtype", None)
                                  or "float32")


def round_config_from_args(args, grad_size: int, group=None) -> RoundConfig:
    """The round's config; the slice predicates go with the axes the
    worker takes (``tp_sliced_param``, ``ep_sliced_param``)."""
    from commefficient_torch.models.gpt2 import tp_sliced_param
    from commefficient_torch.parallel.moe import ep_sliced_param

    telemetry = bool(getattr(args, "telemetry", False))
    wcfg = worker_config_from_args(args, group)
    return RoundConfig(
        worker=wcfg,
        tp_sliced=tp_sliced_param if wcfg.model_axis is not None else None,
        ep_sliced=ep_sliced_param if wcfg.expert_axis is not None else None,
        server=server_config_from_args(args, grad_size), grad_size=grad_size,
        do_test=bool(getattr(args, "do_test", False)),
        stream_sketch=bool(getattr(args, "stream_sketch", False)),
        sketch_coalesce=bool(getattr(args, "sketch_coalesce", False)),
        server_shard=bool(getattr(args, "server_shard", False)),
        collective_plan=collective_plan_from_args(args),
        guards=bool(getattr(args, "guards", False)),
        guard_max_abs=float(getattr(args, "guard_max_abs", 0.0) or 0.0),
        telemetry=telemetry,
        telemetry_hist=telemetry and bool(getattr(args, "telemetry_hist",
                                                  False)))


def _h2d(arr, device, staged: list, dtype=None) -> torch.Tensor:
    """A host array on ``device`` without a wait on the stream: on the card
    the array is staged in pinned host memory and copied with
    ``non_blocking=True`` (a copy from pageable memory synchronizes the
    stream); the pinned buffer is appended to ``staged``, whose owner keeps
    it until the copy has completed. On the CPU, a tensor of the array."""
    t = torch.as_tensor(np.asarray(arr))
    if dtype is not None:
        t = t.to(dtype)
    elif t.is_floating_point():
        t = t.to(torch.float32)
    if torch.device(device).type != "cuda":
        return t
    pinned = t.pin_memory()
    staged.append(pinned)
    return pinned.to(device, non_blocking=True)


def _to_device(batch: dict, device, staged: list) -> dict:
    return {k: _h2d(v, device, staged) for k, v in batch.items()}


def _fetch_all(tensors) -> List[np.ndarray]:
    """Every tensor of ``tensors`` on the host, fetched with one counted
    ``materialize``: their bytes are concatenated on the device and split
    again on the host, so each value is the one a fetch of its own would
    give, bit for bit."""
    from commefficient_torch.profiling import materialize

    if not tensors:
        return []
    flat = [t.detach().contiguous().reshape(-1) for t in tensors]
    buf = materialize(torch.cat([t.view(torch.uint8) for t in flat]))
    out, off = [], 0
    for t, f in zip(tensors, flat):
        n = f.numel() * f.element_size()
        np_dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        out.append(buf[off:off + n].view(np_dtype).reshape(tuple(t.shape)))
        off += n
    return out


class FedModel:
    def __init__(self, model: torch.nn.Module, compute_loss_train: Callable,
                 args, compute_loss_val: Optional[Callable] = None,
                 num_clients: Optional[int] = None,
                 init_params: Optional[torch.Tensor] = None, device=None,
                 group=None):
        """``init_params``: the flat ``(d,)`` weights in JAX ravel order
        (``convert.flat_from_jax``); None draws the model's ``init_`` (GPT-2:
        flax's initializers) or PyTorch's default conv/linear init from a
        generator seeded with ``args.seed``. ``device`` defaults to
        ``args.device``, and that to ``cuda``; with ``group`` (a
        ``ClientGroup``) it is the group's device."""
        from commefficient_torch.config import reject_jax_prng

        reject_jax_prng(args)
        self.group = group
        if group is not None:
            assert group.active, "an idle rank runs no rounds"
            device = group.device
        self.device = resolve_device(device if device is not None
                                     else getattr(args, "device", None))
        set_fp32_numerics()
        self.model = model
        self.args = args
        self.training = True
        num_clients = num_clients or args.num_clients or \
            DEFAULT_NUM_CLIENTS.get(args.dataset_name)
        assert num_clients is not None, \
            "num_clients must come from CLI, dataset, or defaults"
        self.num_clients = int(num_clients)

        self.param_layout = ParamLayout(model)
        self.grad_size = self.param_layout.d
        args.grad_size = self.grad_size
        if init_params is None:
            init_model_(model, args.seed)
            flat = self.param_layout.flatten(dict(model.named_parameters()))
        else:
            flat = init_params.detach().to(torch.float32)
            assert flat.shape == (self.grad_size,), \
                (tuple(flat.shape), self.grad_size)
        # the BatchNorm running statistics (empty without --batchnorm)
        self._model_state = {k: v.to(self.device) for k, v in
                             model.initial_model_state().items()}

        cfg = round_config_from_args(args, self.grad_size, group)
        self.worker_config, self.server_config = cfg.worker, cfg.server
        self.sketch = None
        if args.mode == "sketch":
            self.sketch = make_sketch(self.grad_size, args.num_cols,
                                      args.num_rows, seed=args.seed,
                                      num_blocks=args.num_blocks,
                                      device=self.device)
        # the server reduce axes of the grid and the resolved plan (an
        # explicit spec, the probe's pick under 'auto', or the
        # --reduce_dtype alias), before the round's steps are built
        self._server_axes = (group.server_axes if group is not None
                             else "clients")
        self._axis_sizes = group.axis_sizes if group is not None else None
        self._n_shard = (group.size if cfg.server_shard and group is not None
                         else 0)
        self.collective_plan, self.plan_report = self._resolve_plan(
            args, cfg.collective_plan)
        self._plan_lowering = (plan_lowering(self.collective_plan, group)
                               if cfg.server_shard else None)
        cfg = dataclasses.replace(cfg, collective_plan=self.collective_plan)
        self.round_config = cfg
        self.steps = build_round_step(
            compute_loss_train, compute_loss_val or compute_loss_train,
            self.param_layout, cfg, self.sketch, group=group)
        self.layout = self.steps.layout
        flat = flat.to(self.device)
        self.ps_weights = (self.layout.chunk(flat) if self.layout is not None
                           else flat)
        self._init_client_state(args, cfg.worker, flat)
        self._round_ctx = None
        # DP noise (worker and server); the JAX package seeds its key with
        # seed + 1 too (the streams differ)
        self._rng = torch.Generator(device=self.device).manual_seed(
            int(args.seed) + 1)
        # the current learning rate, published by FedOptimizer (fedavg's
        # local SGD reads it)
        self._opt_lr = 1.0

        # download-byte tracking in the resident layout; chunked-tail
        # positions never change, so they are never counted
        acct_shape = (self.layout.shape if self.layout is not None
                      else (self.grad_size,))
        self._simple_download = (args.num_epochs <= 1
                                 and args.local_batch_size == -1)
        if self._simple_download:
            self._updated_since_init = torch.zeros(
                acct_shape, dtype=torch.bool, device=self.device)
        else:
            self._last_changed = torch.full(acct_shape, -1,
                                            dtype=torch.int32,
                                            device=self.device)
            self._round_idx = 0
            # the same index on the device (a fill, never a copy), so the
            # round marks its changed coordinates without a host wait
            self._round_idx_dev = torch.zeros((), dtype=torch.int32,
                                              device=self.device)
            self._client_part_round = np.zeros(self.num_clients, np.int64)
        self._prev_ps = self.ps_weights
        # --client_dropout draws from a stream of its own (the JAX
        # package's seed + 2; a run state carries it), not the global one
        self._drop_rng = np.random.RandomState(int(args.seed) + 2)
        # the participation layer (participation.attach_participation);
        # None: every sampled client takes part on time
        self._participation = None
        # the open-world population (participation.attach_churn): the
        # sampler's live mask, the disk tier's row directory, the
        # heartbeat's population= and the pop/* checkpoint keys; None: a
        # closed population
        self._population = None
        # an async buffered dispatch skips its server phase
        self._async_skip_server = False
        # the global dispatch counter (RoundHandle.round_no)
        self._rounds_dispatched = 0
        self._last_staleness = None

        # the observability plane: the run's recorder and round tracer
        # (telemetry.attach_run_telemetry; rank 0 only), and the verdict
        # of the last drained round for the heartbeat (None without
        # --guards)
        self.telemetry = None
        self.tracer = None
        self.last_guard_ok = None
        # the last server phase's verdict and metric vector, until
        # seal_round puts them on their round's handle
        self._pending_guard = None
        self._pending_telemetry = None
        # the guard ladder (_note_guard) and its device-resident snapshot
        self.guard_trips = 0
        self._consecutive_trips = 0
        self._max_guard_trips = int(getattr(args, "max_guard_trips", 3))
        self._snapshot_every = int(getattr(args, "snapshot_every", 0) or 0)
        self._rounds_since_snapshot = 0
        self._snapshot = None
        self._optimizer = None   # set by FedOptimizer (the server state)
        # --inject_fault: {dispatch round: poison value}
        from commefficient_torch.config import parse_inject_fault

        inject = getattr(args, "inject_fault", "") or ""
        self._inject = (parse_inject_fault(inject) if isinstance(inject, str)
                        else dict(inject))

    # -- reference API surface -------------------------------------------

    def train(self, training: bool):
        self.training = training

    def _init_client_state(self, args, wcfg: WorkerConfig,
                           flat: torch.Tensor) -> None:
        """The memory plan, its tier, and the client rows in it (see the
        module docstring); the startup lines say what a round moves."""
        plan = plan_client_state_memory(self.num_clients, self.grad_size,
                                        wcfg, sketch=self.sketch,
                                        device=self.device)
        self.memory_plan = plan
        if plan.total_bytes:
            print(plan.summary())
        has_state = wcfg.has_velocity or wcfg.has_error or wcfg.do_topk_down
        self._row_stream = self._row_store = self._prefetcher = None
        self._stream_round = None
        self._pending_offload = None
        io_spec = (getattr(args, "inject_io_fault", "") or "").strip()
        # each round enqueues one gather and one scatter; a slow tier then
        # blocks the dispatch path instead of piling up deltas
        queue_bound = int(getattr(args, "io_queue_bound", 0) or 0) \
            or max(8, 4 * int(getattr(args, "round_window", 2)))
        if plan.placement == "disk" and has_state:
            row_shapes = {}
            state_shape = (self.sketch.table_shape if wcfg.mode == "sketch"
                           else (self.grad_size,))
            if wcfg.has_velocity:
                row_shapes["velocities"] = state_shape
            if wcfg.has_error:
                row_shapes["errors"] = state_shape
            init_rows = {}
            if wcfg.do_topk_down:
                row_shapes["weights"] = (self.grad_size,)
                # rows stored as deltas off the initial weights: no
                # O(clients x d) write at startup
                init_rows["weights"] = flat.detach().cpu().numpy().astype(
                    np.float32)
            self._row_store = MemmapRowStore(
                self._state_dir(args), self.num_clients, row_shapes,
                device=self.device, init_rows=init_rows,
                inject=parse_io_fault(io_spec) if io_spec else None,
                io_retries=int(getattr(args, "io_retries", 3)),
                io_backoff_ms=float(getattr(args, "io_backoff_ms", 5.0)),
                io_deadline_ms=float(getattr(args, "io_deadline_ms",
                                             30000.0)),
                queue_bound=queue_bound,
                checksums=bool(getattr(args, "io_checksums", True)),
                scrub_rows=int(getattr(args, "io_scrub_rows", 0) or 0))
            # the per-round offload span carries counter deltas
            self._io_counts_last = self._row_store.io_counters()
            self._prefetcher = CohortPrefetcher(self._row_store.gather_async)
            self.client_states = ClientStates(None, None, None)
        else:
            if io_spec:
                print(f"NOTE: --inject_io_fault targets the disk-tier row "
                      f"store; this run resolved the {plan.placement} "
                      f"tier, so the schedule is inert")
            where = (state_device(plan, self.device) if has_state
                     else self.device)
            self.client_states = init_client_states(
                self.num_clients, self.grad_size, wcfg, init_weights=flat,
                sketch=self.sketch, device=where)
            if plan.placement == "host" and has_state:
                self._row_stream = RowStreamer(self.client_states,
                                               self.device,
                                               queue_bound=queue_bound)
                self._prefetcher = CohortPrefetcher(
                    self._row_stream.gather_async)
        if self._prefetcher is None:
            return
        n_members = len([m for m in (wcfg.has_velocity, wcfg.has_error,
                                     wcfg.do_topk_down) if m])
        # one slot's bytes over every member (rows can differ in size)
        self._slot_bytes = plan.total_bytes // max(self.num_clients, 1)
        per_round = args.num_workers * self._slot_bytes
        print(f"client state host-offload ({plan.placement} tier): "
              f"streaming {args.num_workers} row slots/round x "
              f"{self._slot_bytes / 2**20:.2f} MiB/slot "
              f"({n_members} state array(s)) = "
              f"{per_round / 2**20:.2f} MiB/round "
              "around the device step"
              + ("" if self._prefetcher.enabled else
                 " (cohort prefetch OFF: COMMEFFICIENT_COHORT_"
                 "PREFETCH=0)"))
        st = self._row_store
        if st is not None:
            print(f"row-store I/O plane: queue bound {st.queue_bound} "
                  f"ops (backpressure), retry ladder {st.io_retries} "
                  f"retries x {st.io_backoff_ms:g} ms backoff, "
                  f"watchdog deadline {st.io_deadline_ms:g} ms, row "
                  f"quarantine after {st.quarantine_after} failed "
                  f"attempts, per-row checksums "
                  + ("ON" if st.checksums else "OFF (--no_io_checksums)")
                  + (f" + scrub {st.scrub_rows} rows/round"
                     if st.scrub_rows else "")
                  + (f", fault injection {st.inject.schedule.spec()}"
                     if st.inject is not None else ""))

    def finalize(self):
        """Drain and join the streamed tier's worker, so every scatter has
        landed (bounded: ``close`` reports a hung worker or a surfaced
        error instead of abandoning it). Both entry points call it on
        every exit path. An I/O error that first surfaces here fails the
        run, unless another exception is already propagating (that one
        carries the failure)."""
        tier = self._row_store or self._row_stream
        if tier is None:
            return
        report = tier.close()
        if report.get("error") and sys.exc_info()[0] is None:
            raise RuntimeError(
                f"row store close surfaced an I/O error: "
                f"{report['error']} — the final rounds' client state "
                f"may not be durable; resume from the last checkpoint "
                f"with --resume auto")

    def _state_dir(self, args) -> str:
        """The disk tier's directory: ``--state_dir``, else
        ``<checkpoint_path>/client_state``; each rank of a client group
        of several ranks keeps its own copy under ``rank<r>`` (``r`` the
        process rank: the seq, model, stage and expert ranks of one tuple
        index each keep one)."""
        base = (getattr(args, "state_dir", "") or "") or os.path.join(
            getattr(args, "checkpoint_path", "."), "client_state")
        g = self.group
        if g is not None and g.inner_size > 1:
            return os.path.join(base, f"rank{g.process_rank}")
        if g is not None and g.size > 1:
            return os.path.join(base, f"rank{g.rank}")
        return base

    @property
    def streaming(self) -> bool:
        """True when per-client state is row-streamed around the round
        (host or disk tier) instead of indexed inside it."""
        return self._prefetcher is not None

    def prefetch_cohort(self, batch: dict) -> None:
        """Enqueue round t+1's row gather while round t computes
        (``engine.cohort_lookahead``); a no-op in the ``hbm`` tier or with
        ``COMMEFFICIENT_COHORT_PREFETCH=0``."""
        if self._prefetcher is not None:
            self._prefetcher.prefetch(np.asarray(batch["client_ids"]))

    def drain_client_state(self) -> None:
        """Barrier on the streamed tier's worker (a run-state save reads
        the rows after it); raises a worker error."""
        tier = self._row_store or self._row_stream
        if tier is not None:
            tier.drain()

    def __call__(self, batch: dict):
        if self.training:
            return self.finish_round(self.begin_round(batch))
        return self._call_val(batch)

    def zero_grad(self):
        pass  # gradients are per-call values

    @property
    def is_main(self) -> bool:
        """True on the process that writes files (rank 0 of the group, or
        the only one)."""
        return self.group is None or self.group.is_main

    def state_dict(self) -> dict:
        """The current weights as a flax-layout tree of numpy arrays (the
        JAX package's ``FedModel.state_dict``: ``convert.flax_from_port``
        of ``params``)."""
        return flax_from_port(self.params, self.param_layout)

    def save_pretrained(self, log_dir: str) -> str:
        """Write the weights and model state as ``<log_dir>/model.npz`` in
        the JAX package's ``save_checkpoint`` format (its
        ``load_checkpoint`` reads it back to the same tree); rank 0 only.
        Returns the path."""
        path = os.path.join(log_dir, "model")
        if self.is_main:
            save_checkpoint(path, flax_from_port(self.params,
                                                 self.param_layout),
                            model_state=self._model_state)
        return path + ".npz"

    @property
    def rounds_dispatched(self) -> int:
        """Global dispatch count: the last dispatched round's
        ``RoundHandle.round_no`` is ``rounds_dispatched - 1``."""
        return self._rounds_dispatched

    @property
    def params(self):
        """``{torch_name: tensor}`` views of the current weights
        (``convert.flax_from_port`` turns them into a flax tree)."""
        w = (self.layout.unchunk(self.ps_weights)
             if self.layout is not None else self.ps_weights)
        return self.param_layout.params(w.detach())

    # -- rounds -------------------------------------------------------------

    def begin_round(self, batch: dict) -> RoundHandle:
        """Run the client phase; metrics and the download count stay on
        the device in the returned handle. Nothing here waits on the
        stream: host data reaches the card through pinned buffers
        (``_h2d``), which the handle keeps.

        ``--client_dropout`` masks each sampled client out with its
        probability (a round where all would drop keeps its cohort). With
        the participation layer attached, its fault schedule splits the
        batch into the on-time slots and the stragglers; the stragglers'
        client phase runs now, against this round's weights and the model
        state before the round, and its un-normalized transmit sum is held
        until its due round (its model state and rows are discarded: a late
        landing folds the transmit only). Then the due stragglers fold
        into this round (``fold_due``), or, under ``--async_buffer``, the
        dispatch folds the buffer or is buffered (``async_step``)."""
        ids = np.asarray(batch["client_ids"])
        wmask = np.asarray(batch["worker_mask"])
        drop_p = getattr(self.args, "client_dropout", 0.0) or 0.0
        if drop_p > 0:
            drop = (self._drop_rng.random_sample(wmask.shape) < drop_p) \
                & (wmask > 0)
            if drop[wmask > 0].all():
                drop[:] = False
            wmask = np.where(drop, 0.0, wmask).astype(np.float32)
            batch = dict(batch)
            batch["worker_mask"] = wmask
            mask = np.asarray(batch["mask"])
            batch["mask"] = (mask * wmask.reshape(
                wmask.shape + (1,) * (mask.ndim - 1))).astype(mask.dtype)
        part = self._participation
        round_no = self._rounds_dispatched
        late_batch = cohort_info = None
        if part is not None:
            batch, late_batch, cohort_info = part.apply_faults(batch,
                                                               round_no)
            wmask = np.asarray(batch["worker_mask"])
        pop = self._population
        if pop is not None and self.telemetry is not None:
            # the churn records the sampler buffered (churn_join,
            # churn_depart, cohort_short), keyed to the round that sampled
            # the changed population
            for ev in pop.pop_events():
                kind = ev.pop("kind")
                self.telemetry.event(kind, round=round_no, **ev)
        live = wmask > 0
        if late_batch is not None:
            # stragglers download this round's model and upload a
            # transmit: the byte accounting counts them
            live = live | (np.asarray(late_batch["worker_mask"]) > 0)
        participating = np.unique(ids[live])
        staged = []
        download_dev, upload = self._account_bytes_deferred(participating,
                                                            staged)
        dbatch = _to_device(batch, self.device, staged)
        states_in = self.client_states
        proxy_ids = None
        if self.streaming:
            states_in, proxy_ids = self._take_rows(ids, round_no, staged)
            dbatch["client_ids"] = proxy_ids
        pre_model_state = self._model_state
        self._round_ctx, self._model_state, metrics = \
            self.steps.client_step(self.ps_weights, states_in,
                                   self._model_state, dbatch, self._opt_lr,
                                   self._rng)
        self._rounds_dispatched += 1
        sharded = self.round_config.server_shard
        if late_batch is not None:
            late_wmask = np.asarray(late_batch["worker_mask"])
            late_count = float(max(np.asarray(late_batch["mask"]).sum(),
                                   1.0))
            # every rank of a group runs this dispatch (its collectives);
            # streamed, the stragglers are a mask split of the cohort the
            # proxy holds, so they ride it with the same ids
            dlate = _to_device(late_batch, self.device, staged)
            if proxy_ids is not None:
                dlate["client_ids"] = proxy_ids
            late_ctx, _, _ = self.steps.client_step(
                self.ps_weights, states_in, pre_model_state, dlate,
                self._opt_lr, self._rng)
            late_sum = (late_ctx.gradient if sharded else
                        _transmit_sum(late_ctx.gradient, _f32(late_count)))
            part.hold(late_sum, late_count, np.unique(ids[late_wmask > 0]),
                      round_no)
        poison = self._inject.get(round_no)
        if poison is not None:
            self._poison_transmit(round_no, poison)
        async_masked = None
        count = float(max(np.asarray(batch["mask"]).sum(), 1.0))
        if part is not None and part.async_k:
            ctx, fold, async_info = part.async_step(
                self._round_ctx, round_no, sharded=sharded, count=count,
                ids=participating)
            self._round_ctx = ctx
            self._async_skip_server = not fold
            async_masked = async_info.pop("masked_dev", None)
            cohort_info = dict(cohort_info or {})
            cohort_info["async"] = async_info
        elif part is not None:
            self._round_ctx, landed = part.fold_due(
                self._round_ctx, round_no, sharded=sharded, count=count)
            if cohort_info is not None:
                if landed:
                    cohort_info["landed"] = landed
                if part.pending:
                    cohort_info["pending"] = len(part.pending)
        staleness, self._last_staleness = self._last_staleness, None
        return RoundHandle(metrics=metrics, valid=wmask > 0,
                           participating=participating,
                           download=download_dev, upload=upload,
                           round_no=round_no, staged=tuple(staged),
                           staleness=staleness, cohort=cohort_info or None,
                           async_masked=async_masked)

    def _take_rows(self, ids: np.ndarray, round_no: int, staged: list):
        """The round's W-row proxy from the prefetcher (the upload's event
        joins the round's stream; its staging buffers join the handle's),
        the proxy ids ``arange(W)``, and the round's ``offload`` record:
        ``gather_ms`` is the dispatch thread's wait, ``gather_io_ms`` the
        disk worker's read and upload; on the disk tier the storage-fault
        counters' deltas and queue, and the ladder's events become
        telemetry events here, on the dispatch thread."""
        t0 = time.perf_counter()
        with annotate("fed_offload_gather"):
            stream, hit = self._prefetcher.take(ids)
        stream.wait_ready()
        staged.extend(stream.staged)
        self._stream_round = stream
        off = {"tier": self.memory_plan.placement,
               "prefetch": "hit" if hit else (
                   "miss" if self._prefetcher.enabled else "off"),
               "gather_ms": round((time.perf_counter() - t0) * 1e3, 3)}
        st = self._row_store
        if st is not None:
            off["gather_io_ms"] = round(st.last_gather_ms, 3)
            counts = st.io_counters()
            last = self._io_counts_last
            off.update({
                "io_retries": counts["retries"] - last["retries"],
                "io_errors": counts["errors"] - last["errors"],
                "io_quarantined": (counts["quarantined"]
                                   - last["quarantined"]),
                "io_corrupt": counts["corrupt"] - last["corrupt"],
                "io_repaired": counts["repaired"] - last["repaired"],
                "scrub_rows": (counts["scrub_checked"]
                               - last["scrub_checked"]),
                "scrub_mismatch": (counts["scrub_mismatch"]
                                   - last["scrub_mismatch"]),
                "queue_depth": st.queue_depth(),
                "queue_age_ms": round(st.queue_age_ms(), 3),
            })
            self._io_counts_last = counts
            for ev in st.pop_events():
                if self.telemetry is not None:
                    kind = ev.pop("kind", "row_quarantined")
                    self.telemetry.event(kind, round=round_no, **ev)
        self._pending_offload = off
        proxy_ids = torch.arange(len(ids), dtype=torch.int64,
                                 device=self.device)
        return stream.proxy, proxy_ids

    def _poison_transmit(self, round_no: int, poison: float) -> None:
        """``--inject_fault``: overwrite element ``(0,) * ndim`` of the
        round's transmit with ``poison`` before the server phase, on the
        device. Under ``--server_shard`` that element is rank 0's partial
        sum, so only rank 0 writes it; elsewhere the transmit is the
        reduced one, written on every rank."""
        rc = self.round_config
        if rc.server_shard and self.group.rank != 0:
            return
        ctx = self._round_ctx
        g = ctx.gradient.clone()
        g.view(-1)[0].fill_(poison)   # on the device: no host copy
        self._round_ctx = ctx._replace(gradient=g)
        print(f"inject_fault: poisoned round {round_no} transmit "
              f"with {poison}")

    def seal_round(self, handle: RoundHandle) -> RoundHandle:
        """After the round's server phase: attach its guard verdict and
        metric vector (device tensors) to the handle, and on the card
        record the event the round engine's window waits on."""
        handle = handle._replace(guard=self._pending_guard,
                                 telemetry=self._pending_telemetry,
                                 offload=self._pending_offload)
        self._pending_guard = self._pending_telemetry = None
        self._pending_offload = None
        if self.device.type != "cuda":
            return handle
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return handle._replace(done=done)

    def finish_round(self, handle: RoundHandle):
        """Fetch a round's results: ``[loss_arr, acc_arr, download,
        upload]``."""
        return self.finish_rounds([handle])[0]

    def finish_rounds(self, handles: Sequence[RoundHandle], on_round=None):
        """Fetch the results of several rounds with one counted
        ``materialize``: their metrics, download counts, guard verdicts
        and (with a recorder attached) metric vectors are stacked and
        copied once. Each round's values are the ones ``finish_round``
        alone gives, bit for bit. Then, round by round in dispatch order:
        the recorder's ``on_metrics``, the guard ladder (``_note_guard``,
        which may raise), and ``on_round(handle, values)`` (the engine's
        per-round host work), as the JAX package does them."""
        from commefficient_torch.telemetry import METRIC_FIELDS

        record = self.telemetry is not None
        tensors = []
        for h in handles:
            tensors.extend(h.metrics)
            tensors.extend(t for t in (
                h.download, h.guard, h.telemetry if record else None,
                h.async_masked) if t is not None)
        host = iter(_fetch_all(tensors))
        out = []
        for h in handles:
            *ms, _count = (next(host) for _ in h.metrics)
            download = np.zeros(self.num_clients, np.float64)
            if h.download is not None:
                counts = next(host)
                if len(h.participating):
                    download[h.participating] = 4.0 * counts
            guard_ok = bool(next(host)) if h.guard is not None else None
            vals = next(host) if record and h.telemetry is not None \
                else None
            if h.async_masked is not None:
                # an async fold's masked contributions: counted, and in
                # the round's async record
                n_masked = int(round(float(next(host))))
                if self._participation is not None:
                    self._participation.note_masked(n_masked)
                if n_masked and h.cohort and "async" in h.cohort:
                    h.cohort["async"]["masked"] = n_masked
            values = [m[h.valid] for m in ms] + [download, h.upload]
            self.last_guard_ok = guard_ok
            # a buffered async dispatch has no server phase and no metric
            # vector, but its round record still lands with its async
            # record
            has_async = bool(h.cohort and "async" in h.cohort)
            if record and (vals is not None or has_async):
                loss = (float(np.mean(ms[0][h.valid]))
                        if len(ms) and np.any(h.valid) else None)
                cohort = {"participants": int(len(h.participating)),
                          "slots": int(np.sum(h.valid))}
                if h.staleness is not None and len(h.staleness):
                    cohort["staleness_mean"] = float(np.mean(h.staleness))
                    cohort["staleness_max"] = int(np.max(h.staleness))
                if h.cohort:
                    cohort.update(h.cohort)
                self.telemetry.on_metrics(
                    h.round_no,
                    ({k: float(v) for k, v in zip(METRIC_FIELDS, vals)}
                     if vals is not None else None),
                    loss=loss, guard_ok=guard_ok, cohort=cohort,
                    offload=h.offload)
            if guard_ok is not None:
                self._note_guard(guard_ok, round_no=h.round_no)
            if on_round is not None:
                on_round(h, values)
            out.append(values)
        return out

    # -- the guard ladder (--guards) ----------------------------------------

    def _note_guard(self, ok: bool, round_no: int = -1) -> None:
        """The host's reaction to a drained verdict (the JAX package's
        ladder): a healthy round counts toward the next snapshot; a trip
        is logged (the round was already quarantined on the device); from
        the second consecutive trip the snapshot, if one was taken, is
        restored; at ``--max_guard_trips`` consecutive trips the run
        raises ``RuntimeError``. Every rank of a group sees the same
        verdicts and takes the same steps."""
        if ok:
            self._consecutive_trips = 0
            self._rounds_since_snapshot += 1
            if self._snapshot_every and \
                    self._rounds_since_snapshot >= self._snapshot_every:
                self._take_snapshot()
            return
        self.guard_trips += 1
        self._consecutive_trips += 1
        print(f"HEALTH GUARD tripped (trip {self.guard_trips}, "
              f"{self._consecutive_trips} consecutive): round quarantined — "
              "contribution and error-feedback carry discarded")
        if self.telemetry is not None:
            self.telemetry.event("guard_trip", round=round_no,
                                 trip=self.guard_trips,
                                 consecutive=self._consecutive_trips)
        if self._consecutive_trips >= self._max_guard_trips:
            if self.telemetry is not None:
                self.telemetry.event("guard_fatal", round=round_no,
                                     consecutive=self._consecutive_trips)
            raise RuntimeError(
                f"health guard tripped {self._consecutive_trips} consecutive "
                f"rounds (--max_guard_trips {self._max_guard_trips}): the "
                "aggregated transmit or updated weights are persistently "
                "non-finite/over-magnitude. Inspect the data pipeline and "
                "LR schedule; resume from the last good run-state "
                "checkpoint with --resume auto.")
        if self._consecutive_trips >= 2 and self._snapshot is not None:
            self._restore_snapshot()
            if self.telemetry is not None:
                self.telemetry.event("rollback", round=round_no,
                                     consecutive=self._consecutive_trips)

    @staticmethod
    def _clone_state(state):
        ps, ss, ms = state

        def clone(x):
            if isinstance(x, tuple):  # per-level carries
                return tuple(clone(v) for v in x)
            return None if x is None else x.clone()

        return (ps.clone(), type(ss)(*(clone(x) for x in ss)),
                {k: v.clone() for k, v in ms.items()})

    def _take_snapshot(self) -> None:
        """Refresh the device-resident last-good snapshot: clones of the
        weights, the server state and the model state (the rounds update
        client rows in place and replace the rest; a clone stays as
        taken)."""
        if self._optimizer is None:
            return
        self._snapshot = self._clone_state(
            (self.ps_weights, self._optimizer.server_state,
             self._model_state))
        self._rounds_since_snapshot = 0

    def _restore_snapshot(self) -> None:
        """Roll the weights, server state and model state back to a fresh
        clone of the snapshot (which stays intact for later rollbacks).
        Per-client state is not in the snapshot, as in the JAX package:
        the guard kept its rows finite, and error feedback absorbs the
        skew; bit-exact recovery is ``--resume``."""
        ps, ss, ms = self._clone_state(self._snapshot)
        self.ps_weights = ps
        self._optimizer.server_state = ss
        self._model_state = ms
        self._prev_ps = ps
        print("HEALTH GUARD: consecutive trips — rolled server state back "
              "to the last-good snapshot; training continues")

    def sr_generators(self, round_no: int):
        """The quantized legs' stochastic-rounding generators for round
        ``round_no`` on this rank (``ops/collectives.level_sr_generators``:
        a generator a flat quantized leg, a tuple a level of a per-axis
        one), None under an exact plan."""
        plan = self.round_config.collective_plan
        if plan is None or not plan.quantized:
            return None
        low = leg_lowerings(plan, self._plan_lowering)
        up = low["table"] if self.server_config.mode == "sketch" \
            else low["uplink"]
        return {name: level_sr_generators(self.args.seed, round_no, name,
                                          leg, self.group, self.device)
                for name, leg in (("up", up), ("down", low["downlink"]))}

    def _plan_leg_geoms(self) -> dict:
        """``{leg: (elements, quant block)}`` of the wire legs this config
        runs, at the blocks the collectives use (the probe measures the
        real geometry): sketch mode has a table and a downlink leg, the
        dense modes an uplink and a downlink."""
        n = max(self._n_shard, 1)
        if self.server_config.mode == "sketch":
            sk = self.sketch
            return {"table": (sk.r * sk.c_pad, sk.c_pad),
                    "downlink": (-(-sk.T // n) * n * sk.sublanes * 128,
                                 sk.sublanes * 128)}
        d_pad = -(-self.grad_size // n) * n
        return {"uplink": (d_pad, DEFAULT_QUANT_BLOCK),
                "downlink": (d_pad, DEFAULT_QUANT_BLOCK)}

    def _resolve_plan(self, args, plan):
        """The collective plan, resolved once before the round's steps are
        built: ``plan`` is the parsed ``--collective_plan`` (or the
        ``--reduce_dtype`` alias), None under ``auto``, which runs the
        probe over this config's leg geometries on this device. Returns
        ``(plan, probe report or None)``; both reach the telemetry
        ``run_start`` event. A per-axis plan is resolved against the grid
        by ``plan_lowering`` next, so an axis the grid lacks fails at
        start-up with the axis list."""
        report = None
        if plan is None:
            assert self._n_shard, \
                "--collective_plan auto requires --server_shard (the " \
                "quantized collectives live on the sharded server plane)"
            budget = float(getattr(args, "plan_error_budget", 0.05) or 0.05)
            plan, report = autotune_collective_plan(
                self._plan_leg_geoms(), error_budget=budget,
                seed=int(getattr(args, "seed", 0)), device=self.device)
            print(f"collective_plan auto -> {plan.spec()} "
                  f"(error budget {budget:g}; probe report in the "
                  "telemetry run_start event)")
        elif "=" in (getattr(args, "collective_plan", "") or ""):
            # a named leg this mode never runs would log compression it
            # does not do
            unused = ("uplink" if self.server_config.mode == "sketch"
                      else "table")
            if leg_quantized(getattr(plan, unused)):
                import warnings

                warnings.warn(
                    f"--collective_plan names {unused}="
                    f"{getattr(plan, unused)}, but mode="
                    f"{self.server_config.mode} has no {unused} leg — "
                    "that entry will not compress anything")
        if plan.quantized:
            assert self._n_shard, \
                "quantized collective legs (--collective_plan / " \
                "--reduce_dtype int8) require --server_shard"
        return plan, report

    def _apply_server(self, server_state, lr):
        """Phase 2 for ``FedOptimizer.step()``; the verdict and the metric
        vector wait on the device for ``seal_round``. An async buffered
        dispatch skips it: the weights, the server state and the client
        rows stay as they are (a streamed proxy is dropped unscattered),
        the generator is not drawn, and there is no verdict and no vector.

        Streamed, the server step updates the W-row proxy and the deltas
        against the rows before the round (the round context's ``*_rows``,
        copies) go to the tier's worker; on the disk tier a scrub pass
        follows the scatter on the same worker."""
        if self._async_skip_server:
            self._async_skip_server = False
            self._round_ctx = None
            self._stream_round = None
            return server_state
        ctx = self._round_ctx
        stream = self._stream_round
        states = self.client_states if stream is None else stream.proxy
        out = self.steps.server_step(self.ps_weights, server_state,
                                     states, ctx, lr, self._rng,
                                     sr=self.sr_generators(
                                         self._rounds_dispatched - 1))
        self.ps_weights, new_state, new_states = out[:3]
        if stream is None:
            self.client_states = new_states
        else:
            proxy = stream.proxy
            old = ClientStates(
                velocities=(ctx.vel_rows if proxy.velocities is not None
                            else None),
                errors=ctx.err_rows if proxy.errors is not None else None,
                weights=(ctx.stale_rows if proxy.weights is not None
                         else None))
            t0 = time.perf_counter()
            tier = self._row_store or self._row_stream
            tier.scatter(stream, old, new_states)
            if self._row_store is not None:
                self._row_store.scrub_async()
            self._stream_round = None
            if self._pending_offload is not None:
                self._pending_offload["scatter_ms"] = round(
                    (time.perf_counter() - t0) * 1e3, 3)
                if self._row_store is not None:
                    # the last completed write (this round's overlaps the
                    # next round's compute)
                    self._pending_offload["scatter_io_ms"] = round(
                        self._row_store.last_scatter_ms, 3)
        extra = iter(out[3:])
        rc = self.round_config
        self._pending_guard = next(extra) if rc.guards else None
        self._pending_telemetry = next(extra) if rc.telemetry else None
        self._round_ctx = None
        return new_state

    def _call_val(self, batch: dict):
        metrics = self.steps.val_step(self.ps_weights, self._model_state,
                                      _to_device(batch, self.device, []))
        *ms, _count = _fetch_all(metrics)
        return [np.array([m]) for m in ms]

    def _account_bytes_deferred(self, participating,
                                staged: Optional[list] = None):
        """Byte accounting without a host sync: the download value is a
        device tensor, fetched in ``finish_round``. The participants'
        last rounds reach the device through ``_h2d`` (pinned buffers
        appended to ``staged``)."""
        upload = np.zeros(self.num_clients, np.float64)
        upload[participating] = {
            "uncompressed": self.grad_size,
            "true_topk": self.grad_size,
            "local_topk": self.args.k,
            # the lane-aligned table actually transmitted
            "sketch": (int(np.prod(self.sketch.table_shape))
                       if self.sketch is not None else 0),
            "fedavg": self.grad_size,
        }[self.args.mode] * 4
        download_dev = None
        if self._simple_download:
            self._updated_since_init |= self.ps_weights != self._prev_ps
            self._prev_ps = self.ps_weights
            download_dev = torch.sum(self._updated_since_init)
        else:
            self._last_changed = torch.where(
                self.ps_weights != self._prev_ps, self._round_idx_dev,
                self._last_changed)
            self._prev_ps = self.ps_weights
            self._round_idx += 1
            self._round_idx_dev = self._round_idx_dev + 1
            if len(participating):
                since = _h2d(self._client_part_round[participating],
                             self.device, [] if staged is None else staged,
                             dtype=torch.int32)
                download_dev = torch.stack([
                    torch.sum(self._last_changed >= s) for s in since])
            # the cohort's staleness (the telemetry cohort record)
            self._last_staleness = (
                self._round_idx
                - self._client_part_round[participating]).astype(np.int64)
            self._client_part_round[participating] = self._round_idx
        return download_dev, upload


class FedOptimizer:
    """Server-side optimizer.

    ``param_groups``: ``(mask, base_lr)`` pairs over the flat vector (a
    boolean ``(d,)`` mask, or None for every coordinate), applied in
    order, later groups overwriting earlier ones: Fixup's per-group LRs
    and finetune freezing (base 0). The single default group ``(None,
    1.0)`` keeps a scalar LR; any other list becomes a per-coordinate
    base-LR vector on the device, in the resident layout of the weights
    (sketch mode: the chunked ``(T, S, 128)`` layout with a zero tail, so
    padded coordinates never move). ``get_lr`` is the vector times the
    schedule's factor, and fedavg's clients take it (``_opt_lr``)."""

    def __init__(self, fed_model: FedModel, args,
                 param_groups: Optional[Sequence[Tuple[Optional[np.ndarray],
                                                       float]]] = None):
        self.fed_model = fed_model
        self.args = args
        self.param_groups = param_groups or [(None, 1.0)]
        self._lr_factor = 0.0
        self._lr = 0.0
        # the guard's snapshot and rollback reach the server state here
        fed_model._optimizer = self
        rc = fed_model.round_config
        self.server_state = init_server_state(
            fed_model.server_config, fed_model.sketch,
            device=fed_model.device,
            shard_n=fed_model._n_shard, plan=rc.collective_plan,
            lowering=fed_model._plan_lowering,
            axis_sizes=fed_model._axis_sizes)
        self._base_lr_vec = None
        if len(self.param_groups) > 1 or self.param_groups[0][0] is not None:
            vec = np.zeros(fed_model.grad_size, np.float32)
            for mask, base in self.param_groups:
                if mask is None:
                    vec[:] = base
                else:
                    vec[np.asarray(mask)] = base
            vec = torch.from_numpy(vec).to(fed_model.device)
            if fed_model.layout is not None:
                vec = fed_model.layout.chunk(vec)
            self._base_lr_vec = vec

    def get_lr(self):
        """The scalar factor for the default group, else the
        per-coordinate vector ``base_lr_vec * factor``."""
        return self._lr

    def set_lr_factor(self, factor: float):
        self._lr_factor = float(factor)
        self._lr = (self._lr_factor if self._base_lr_vec is None
                    else self._base_lr_vec * self._lr_factor)
        # publish to the model so fedavg's clients see the current lr
        self.fed_model._opt_lr = self._lr

    def step(self):
        fm = self.fed_model
        assert fm._round_ctx is not None, "call model(batch) before step()"
        self.server_state = fm._apply_server(self.server_state, self.get_lr())

    def zero_grad(self):
        raise NotImplementedError("call zero_grad() on the model instead")


class LambdaLR:
    """Minimal LambdaLR driving FedOptimizer; ``get_last_lr`` lists one LR
    per parameter group."""

    def __init__(self, optimizer: FedOptimizer,
                 lr_lambda: Callable[[int], float]):
        self.optimizer = optimizer
        self.lr_lambda = lr_lambda
        self._step_count = 0
        optimizer.set_lr_factor(lr_lambda(0))

    def step(self):
        self._step_count += 1
        self.optimizer.set_lr_factor(self.lr_lambda(self._step_count))

    def get_last_lr(self) -> List[float]:
        factor = self.lr_lambda(self._step_count)
        return [factor * base for _, base in self.optimizer.param_groups]
