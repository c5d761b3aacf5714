"""FedModel / FedOptimizer / LambdaLR: the port of
``commefficient_tpu/federated/aggregator.py``.

Call-surface parity with the reference: ``FedModel`` is callable like a
model; a train round returns ``[loss_array, acc_array, download_bytes,
upload_bytes]``, a val call ``[loss_array, acc_array]``; ``FedOptimizer``
exposes ``step()`` / ``get_lr()`` and is driven by ``LambdaLR``. A round is
``lr_scheduler.step(); model(batch); opt.step()``.

Byte accounting, both of the JAX package's regimes: upload is 4 B x the
transmitted table size for each participating client; download regime (a)
(single-epoch, whole-client batches) charges the popcount of an
updated-since-init mask, regime (b) charges each sampled client the count
of coordinates changed since it last participated, from a device-resident
per-coordinate last-changed round index.

This slice runs the fused sketch-mode round on one device. Options of the
JAX package that it does not carry raise ``NotImplementedError`` naming the
ROADMAP item (``config.reject_unported``).
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from commefficient_torch.federated.rounds import (
    RoundConfig,
    build_round_step,
)
from commefficient_torch.federated.server import (
    ServerConfig,
    init_server_state,
)
from commefficient_torch.federated.worker import WorkerConfig
from commefficient_torch.models.layers import torch_conv_init_
from commefficient_torch.ops.flat import ParamLayout
from commefficient_torch.ops.sketch import make_sketch

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


def set_fp32_numerics() -> None:
    """The JAX reference computes in float32: turn TF32 off for cuDNN
    convolutions and cuBLAS matrix products."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


class RoundHandle(NamedTuple):
    """A dispatched round: device metrics and the deferred download
    count; ``valid``/``participating``/``upload`` are host data."""

    metrics: Tuple[Any, ...]
    valid: np.ndarray
    participating: np.ndarray
    download: Optional[Any]
    upload: np.ndarray


def worker_config_from_args(args) -> WorkerConfig:
    return WorkerConfig(
        mode=args.mode, error_type=args.error_type, k=args.k,
        num_workers=args.num_workers, weight_decay=args.weight_decay,
        local_momentum=args.local_momentum,
        microbatch_size=args.microbatch_size,
        max_grad_norm=args.max_grad_norm)


def server_config_from_args(args, grad_size: int) -> ServerConfig:
    return ServerConfig(
        mode=args.mode, error_type=args.error_type, k=args.k,
        grad_size=grad_size, virtual_momentum=args.virtual_momentum,
        local_momentum=args.local_momentum)


def _to_device(batch: dict, device) -> dict:
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        if t.is_floating_point():
            t = t.to(torch.float32)
        out[k] = t.to(device)
    return out


class FedModel:
    def __init__(self, model: torch.nn.Module, compute_loss_train: Callable,
                 args, compute_loss_val: Optional[Callable] = None,
                 num_clients: Optional[int] = None,
                 init_params: Optional[torch.Tensor] = None, device=None):
        """``init_params``: the flat ``(d,)`` weights in JAX ravel order
        (``convert.flat_from_jax``); None draws PyTorch's default init from
        a generator seeded with ``args.seed``. ``device`` defaults to
        ``args.device``, and that to ``cuda``."""
        from commefficient_torch.config import reject_unported

        reject_unported(args)
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
            gen = torch.Generator().manual_seed(int(args.seed))
            torch_conv_init_(model, gen)
            flat = self.param_layout.flatten(dict(model.named_parameters()))
        else:
            flat = init_params.detach().to(torch.float32)
            assert flat.shape == (self.grad_size,), \
                (tuple(flat.shape), self.grad_size)
        # the slice's CV models carry no BatchNorm statistics
        self._model_state = {}

        wcfg = worker_config_from_args(args)
        scfg = server_config_from_args(args, self.grad_size)
        self.worker_config, self.server_config = wcfg, scfg
        self.sketch = make_sketch(self.grad_size, args.num_cols,
                                  args.num_rows, seed=args.seed,
                                  num_blocks=args.num_blocks,
                                  device=self.device)
        cfg = RoundConfig(worker=wcfg, server=scfg, grad_size=self.grad_size)
        self.steps = build_round_step(
            compute_loss_train, compute_loss_val or compute_loss_train,
            self.param_layout, cfg, self.sketch)
        self.layout = self.steps.layout
        self.ps_weights = self.layout.chunk(flat.to(self.device))
        self._round_table = None

        # download-byte tracking; chunked-tail positions never change, so
        # they are never counted
        self._simple_download = (args.num_epochs <= 1
                                 and args.local_batch_size == -1)
        if self._simple_download:
            self._updated_since_init = torch.zeros(
                self.layout.shape, dtype=torch.bool, device=self.device)
        else:
            self._last_changed = torch.full(self.layout.shape, -1,
                                            dtype=torch.int32,
                                            device=self.device)
            self._round_idx = 0
            self._client_part_round = np.zeros(self.num_clients, np.int64)
        self._prev_ps = self.ps_weights

    # -- reference API surface -------------------------------------------

    def train(self, training: bool):
        self.training = training

    def finalize(self):
        """No worker processes or I/O threads to join."""

    def __call__(self, batch: dict):
        if self.training:
            return self.finish_round(self.begin_round(batch))
        return self._call_val(batch)

    def zero_grad(self):
        pass  # gradients are per-call values

    @property
    def params(self):
        """``{torch_name: tensor}`` views of the current weights
        (``convert.flax_from_port`` turns them into a flax tree)."""
        return self.param_layout.params(
            self.layout.unchunk(self.ps_weights).detach())

    # -- rounds -------------------------------------------------------------

    def begin_round(self, batch: dict) -> RoundHandle:
        """Run the client phase; metrics and the download count stay on
        the device in the returned handle."""
        ids = np.asarray(batch["client_ids"])
        wmask = np.asarray(batch["worker_mask"])
        participating = np.unique(ids[wmask > 0])
        download_dev, upload = self._account_bytes_deferred(participating)
        dbatch = _to_device(batch, self.device)
        self._round_table, self._model_state, metrics = \
            self.steps.client_step(self.ps_weights, self._model_state, dbatch)
        return RoundHandle(metrics=metrics, valid=wmask > 0,
                           participating=participating,
                           download=download_dev, upload=upload)

    def finish_round(self, handle: RoundHandle):
        """Fetch a round's results: ``[loss_arr, acc_arr, download,
        upload]``."""
        *ms, _count = (m.detach().cpu().numpy() for m in handle.metrics)
        download = np.zeros(self.num_clients, np.float64)
        if handle.download is not None and len(handle.participating):
            download[handle.participating] = \
                4.0 * handle.download.cpu().numpy()
        return [m[handle.valid] for m in ms] + [download, handle.upload]

    def _apply_server(self, server_state, lr):
        """Phase 2 for ``FedOptimizer.step()``."""
        new_ps, new_state = self.steps.server_step(
            self.ps_weights, server_state, self._round_table, lr)
        self.ps_weights = new_ps
        self._round_table = None
        return new_state

    def _call_val(self, batch: dict):
        metrics = self.steps.val_step(self.ps_weights, self._model_state,
                                      _to_device(batch, self.device))
        *ms, _count = (m.cpu().numpy() for m in metrics)
        return [np.array([m]) for m in ms]

    def _account_bytes_deferred(self, participating):
        """Byte accounting without a host sync: the download value is a
        device tensor, fetched in ``finish_round``."""
        upload = np.zeros(self.num_clients, np.float64)
        # the lane-aligned table actually transmitted
        upload[participating] = int(np.prod(self.sketch.table_shape)) * 4
        download_dev = None
        if self._simple_download:
            self._updated_since_init |= self.ps_weights != self._prev_ps
            self._prev_ps = self.ps_weights
            download_dev = torch.sum(self._updated_since_init)
        else:
            self._last_changed = torch.where(
                self.ps_weights != self._prev_ps,
                torch.tensor(self._round_idx, dtype=torch.int32,
                             device=self.device),
                self._last_changed)
            self._prev_ps = self.ps_weights
            self._round_idx += 1
            if len(participating):
                since = torch.as_tensor(
                    self._client_part_round[participating],
                    dtype=torch.int32, device=self.device)
                download_dev = torch.stack([
                    torch.sum(self._last_changed >= s) for s in since])
            self._client_part_round[participating] = self._round_idx
        return download_dev, upload


class FedOptimizer:
    """Server-side optimizer. ``param_groups`` other than the single
    default group (Fixup per-group LRs, finetune freezing) are a later
    slice (ROADMAP.md, queue 1)."""

    def __init__(self, fed_model: FedModel, args,
                 param_groups: Optional[Sequence[Tuple[Optional[np.ndarray],
                                                       float]]] = None):
        self.fed_model = fed_model
        self.args = args
        self.param_groups = param_groups or [(None, 1.0)]
        if len(self.param_groups) > 1 or self.param_groups[0][0] is not None:
            raise NotImplementedError(
                "per-parameter-group learning rates are not ported yet "
                "(ROADMAP.md, queue 1: Fixup LR groups and finetuning)")
        self._lr_factor = 0.0
        self.server_state = init_server_state(fed_model.server_config,
                                              fed_model.sketch)

    def get_lr(self):
        return self._lr_factor

    def set_lr_factor(self, factor: float):
        self._lr_factor = float(factor)

    def step(self):
        fm = self.fed_model
        assert fm._round_table is not None, "call model(batch) before step()"
        self.server_state = fm._apply_server(self.server_state, self.get_lr())

    def zero_grad(self):
        raise NotImplementedError("call zero_grad() on the model instead")


class LambdaLR:
    """Minimal LambdaLR driving FedOptimizer."""

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
