"""CV federated training entry point of the port (every model of the
registry that the JAX package's ``cv_train`` trains, on CIFAR10/100,
EMNIST and ImageNet, every ``--mode``).

    python -m commefficient_torch.cv_train --dataset_name CIFAR10 \
        --dataset_dir ./dataset --mode sketch --error_type virtual \
        --local_momentum 0 --virtual_momentum 0.9 --num_workers 8 \
        --num_clients 1000 --iid --num_epochs 24

``--mode true_topk`` (with ``--error_type virtual``), ``local_topk`` (with
``--error_type local`` or ``none``), ``uncompressed`` and ``fedavg`` (with
``--local_batch_size -1 --local_momentum 0 --error_type none``; the
learning rate is applied on the clients) take the same command line.
``--test`` runs one round and one eval batch of a one-channel ResNet9
with an all-ones transmit.

    python -m commefficient_torch.cv_train --dataset_name EMNIST \
        --model ResNet101LN --dataset_dir ./femnist --mode sketch \
        --error_type virtual --local_momentum 0 --virtual_momentum 0.9 \
        --num_workers 8 --local_batch_size 16 --num_epochs 1

The models (``--model``): the JAX package's registry. EMNIST gets
1-channel stems, and every stem takes the dataset's channels (flax infers
them from the batch); model options are filtered by each model's
signature, as the JAX package does. Fixup models (``--model Fixup*``)
train with three LR groups (biases 0.1, scales 0.1, the rest 1.0);
``--finetune --finetuned_from DATASET --finetune_path DIR`` starts from
``DIR/<model>.npz`` (a ``--checkpoint`` file), loading every leaf whose
path and shape match, and trains the head alone (the JAX package's
masks, ``build_param_groups``). A model with BatchNorm that
``--batchnorm`` does not gate (ResNet18, the resnets with
``norm="batch"``) raises: the JAX package cannot train it either.
``--train_dataloader_workers`` / ``--val_dataloader_workers`` > 0 put
the loaders behind ``PrefetchLoader``.
``--seq_parallel`` (GPT-2's sequence parallelism) raises
``ValueError`` (``check_no_seq_parallel``).

CLI and loop parity with ``cv_train.py`` of the JAX package: the same flags
(config.py), a ``PiecewiseLinear`` LR peaking at ``--pivot_epoch``, the NaN
abort, per-epoch ``TableLogger`` rows and byte totals. The training loop
drives ``federated/engine.PipelinedRoundEngine`` over
``cohort_lookahead(loader)``: each round is dispatched without a host wait,
at most ``--round_window`` rounds ahead of the card, and the metrics are
fetched every ``--metrics_drain_every`` rounds (the NaN abort fires at
drain time). ``--checkpoint_every`` saves the run state every N epochs,
``--checkpoint_every_rounds`` every N rounds (after a drain, with the
sampler's position and the partial epoch accumulators), ``--resume
PATH|auto`` restores one (``federated/checkpoint.py``; a mid-epoch resume
ends bit-identical to the run it continues), and ``--checkpoint`` writes
the final weights as ``<checkpoint_path>/<model>.npz``. ``--batchnorm``
puts flax's BatchNorm in every ResNet9 cell. Runs on ``cuda`` unless
``--device cpu``; float32 (TF32 off), the forward and backward in
bfloat16 under ``--bf16``.

The observability plane is on by default, as in the JAX package: each
round's metric vector and the run's events go to
``<run_dir>/telemetry.jsonl`` (``runs/<time>_w..._c..._<mode>...``, or
``$COMMEFFICIENT_RUN_DIR``; ``scripts/obs_report.py`` renders it), the
watch rules run over the drained rounds (their checkpoint reaction saves
the run state at the next round boundary; under ``torchrun``, where rank
0 alone runs them, every rank takes the request at the next drain),
``--trace_rounds`` windows land in ``<run_dir>/trace_round_<N>/``,
``--profile`` traces ``--profile_steps`` rounds of each epoch on rank 0
into ``--profile_dir`` and
``--tensorboard`` writes per-epoch scalars to the run dir. ``--guards``
quarantines a non-finite round on the device, rolls back to the last
snapshot after two consecutive trips and stops the run at
``--max_guard_trips``; ``--inject_fault ROUND:nan|inf`` poisons a round's
transmit to exercise it.

``--churn join=R,depart=R,init=F,seed=N,compact=N`` opens the client
population (``federated/participation.attach_churn``): the sampler draws
from the live clients only, the churn records and the end-of-run
``churn_audit`` go to the event log, and an epoch that draws no cohort
ends training. ``python -m commefficient_torch.scripts.supervise``
restarts a crashed or hung run with ``--resume auto``, and ``python -m
commefficient_torch.scripts.serve`` serves its newest checkpoint.

On N GPUs, one process per GPU:

    torchrun --nproc_per_node N -m commefficient_torch.cv_train ... \
        [--server_shard] [--collective_plan int8]

Each rank reads the same seeded batches and runs its ``W / n`` slots of
every round (``parallel/mesh.py``; rank 0 prepares a synthetic dataset
first); only rank 0 prints and writes files. The process group is
destroyed on exit.
"""

from __future__ import annotations

import inspect
import math
import os

import numpy as np
import torch

from commefficient_torch import models
from commefficient_torch.config import parse_args
from commefficient_torch.data_utils import (
    FedCIFAR10,
    FedCIFAR100,
    FedEMNIST,
    FedImageNet,
    FedLoader,
    PrefetchLoader,
    num_classes_of_dataset,
    transforms,
)
from commefficient_torch.convert import flax_from_port, params_from_flax
from commefficient_torch.federated import FedModel, FedOptimizer, LambdaLR
from commefficient_torch.federated.aggregator import (
    init_model_,
    resolve_device,
    set_fp32_numerics,
)
from commefficient_torch.federated.checkpoint import (
    load_checkpoint,
    load_matching,
    maybe_save_run_state,
    restore_mid_epoch,
    resume_run,
    save_checkpoint,
    save_round_state,
)
from commefficient_torch.federated.engine import (
    PipelinedRoundEngine,
    cohort_lookahead,
)
from commefficient_torch.federated.losses import make_cv_losses
from commefficient_torch.federated.participation import (
    attach_churn,
    attach_participation,
    audit_churn,
    expire_participation,
)
from commefficient_torch.models import ResNet9
from commefficient_torch.ops.flat import ParamLayout
from commefficient_torch.parallel import (
    destroy_distributed,
    main_first,
    quiet_unless_main,
    start_client_group,
)
from commefficient_torch.profiling import StepProfiler
from commefficient_torch.telemetry import (
    attach_run_telemetry,
    close_run_telemetry,
    take_watch_checkpoint,
    watch_can_checkpoint,
)
from commefficient_torch.utils import (
    PiecewiseLinear,
    TableLogger,
    Timer,
    make_logdir,
)


def get_data_loaders(args):
    train_transforms, val_transforms = {
        "ImageNet": (transforms.imagenet_train_transforms,
                     transforms.imagenet_val_transforms),
        "CIFAR10": (transforms.cifar10_train_transforms,
                    transforms.cifar10_test_transforms),
        "CIFAR100": (transforms.cifar100_train_transforms,
                     transforms.cifar100_test_transforms),
        "EMNIST": (transforms.femnist_train_transforms,
                   transforms.femnist_test_transforms),
    }[args.dataset_name]
    dataset_class = {"CIFAR10": FedCIFAR10, "CIFAR100": FedCIFAR100,
                     "EMNIST": FedEMNIST,
                     "ImageNet": FedImageNet}[args.dataset_name]
    train_dataset = dataset_class(args.dataset_dir, args.dataset_name,
                                  train_transforms, args.do_iid,
                                  args.num_clients, train=True, download=True)
    test_dataset = dataset_class(args.dataset_dir, args.dataset_name,
                                 val_transforms, train=False, download=False)
    train_loader = FedLoader(train_dataset, args.num_workers,
                             args.local_batch_size)
    test_loader = FedLoader(test_dataset,
                            val_batch_size=args.valid_batch_size
                            * args.num_workers)
    # a background thread assembles the next batches while the card works
    if args.train_dataloader_workers > 0:
        train_loader = PrefetchLoader(train_loader)
    if args.val_dataloader_workers > 0:
        test_loader = PrefetchLoader(test_loader)
    return train_loader, test_loader


def run_batches(model, opt, lr_scheduler, loader, training, epoch_fraction,
                args, epoch=0, resume_mid=None, totals=(0.0, 0.0)):
    if not training and epoch_fraction != 1:
        raise ValueError("Must do full epochs for val")
    model.train(training)
    losses, accs = [], []
    if training:
        num_clients = loader.dataset.num_clients
        client_download = np.zeros(num_clients)
        client_upload = np.zeros(num_clients)
        spe = loader.steps_per_epoch()
        # mid-epoch resume: the sampler replays its saved position (the
        # global np RNG was restored by load_run_state) and the partial
        # epoch accumulators reload
        i0, ex = restore_mid_epoch(resume_mid, loader, client_download,
                                   client_upload)
        losses.extend(np.asarray(ex.get("losses", [])).tolist())
        accs.extend(np.asarray(ex.get("accs", [])).tolist())
        # rounds are dispatched without a host wait and their metrics
        # fetched every --metrics_drain_every rounds, so the NaN abort
        # fires at drain time
        engine = PipelinedRoundEngine(
            model, opt, lr_scheduler, window=args.round_window,
            drain_every=args.metrics_drain_every)
        prof = StepProfiler(args.profile_dir, num_steps=args.profile_steps,
                            enabled=args.do_profile and model.is_main)
        nan_loss = False
        save_every = int(args.checkpoint_every_rounds or 0)
        # the watch plane's checkpoint reaction is serviced here, at a
        # round boundary, like --checkpoint_every_rounds
        rt = getattr(model, "telemetry", None)
        watch_armed = watch_can_checkpoint(args)

        def consume(results):
            nonlocal nan_loss, client_download, client_upload
            for res in results:
                loss, acc, download, upload = res.values
                if np.any(np.isnan(loss)):
                    print(f"LOSS OF {np.mean(loss)} IS NAN, "
                          "TERMINATING TRAINING")
                    nan_loss = True
                    return
                client_download += download
                client_upload += upload
                losses.extend(loss.tolist())
                accs.extend(acc.tolist())

        try:
            for i, batch in enumerate(cohort_lookahead(loader, model)):
                if i0 + i > spe * epoch_fraction:
                    break
                prof.step(i)
                done = engine.submit(batch)
                consume(done)
                if nan_loss:
                    return np.nan, np.nan, np.nan, np.nan
                do_save = bool(save_every and (i0 + i + 1) % save_every == 0)
                forced = False
                if take_watch_checkpoint(model, watch_armed, bool(done)):
                    if args.train_dataloader_workers == 0:
                        do_save = forced = True
                    else:
                        print("watch: checkpoint reaction skipped (needs "
                              "--train_dataloader_workers 0 for a "
                              "resumable save)")
                if do_save:
                    # drain first: the saved sampler and RNG position must
                    # describe exactly the rounds folded into the run state
                    consume(engine.drain())
                    if nan_loss:
                        return np.nan, np.nan, np.nan, np.nan
                    save_round_state(
                        args, epoch, i0 + i + 1, loader.sampler.get_state(),
                        model, opt, lr_scheduler, totals,
                        extras={"download": client_download,
                                "upload": client_upload,
                                "losses": np.asarray(losses, np.float64),
                                "accs": np.asarray(accs, np.float64)})
                    if rt is not None:
                        # `round` is the global round index the round and
                        # guard events share
                        rt.event("checkpoint", epoch=epoch,
                                 round=model.rounds_dispatched - 1,
                                 round_in_epoch=i0 + i + 1,
                                 **({"forced_by_watch": True} if forced
                                    else {}))
                if args.do_test:
                    break
            consume(engine.drain())
            if nan_loss:
                return np.nan, np.nan, np.nan, np.nan
        finally:
            prof.close()
        if not losses and getattr(model, "_population", None) is not None:
            # --churn's open-world end: the live population emptied before
            # this epoch drew a cohort and no joiner can refill it, a clean
            # end of training, not a NaN
            return None, None, client_download, client_upload
        return (np.mean(losses), np.mean(accs), client_download,
                client_upload)
    for batch in loader:
        loss, acc = model(batch)
        losses.extend(loss.tolist())
        accs.extend(acc.tolist())
        if args.do_test:
            break
    return np.mean(losses), np.mean(accs), None, None


def train(model, opt, lr_scheduler, train_loader, test_loader, args,
          loggers=(), timer=None, start_epoch=0, totals=(0.0, 0.0),
          resume_mid=None, writer=None):
    timer = timer or Timer()
    total_download, total_upload = totals
    if args.eval_before_start and start_epoch == 0:
        _, test_acc, _, _ = run_batches(model, None, None, test_loader,
                                        False, 1, args)
        timer()
        print(f"Test acc at epoch 0: {test_acc:0.4f}")
    summary = {}
    for epoch in range(start_epoch, math.ceil(args.num_epochs)):
        if epoch == math.ceil(args.num_epochs) - 1:
            epoch_fraction = args.num_epochs - epoch
        else:
            epoch_fraction = 1
        train_loss, train_acc, download, upload = run_batches(
            model, opt, lr_scheduler, train_loader, True, epoch_fraction,
            args, epoch=epoch,
            resume_mid=(resume_mid if epoch == start_epoch else None),
            totals=(total_download, total_upload))
        if train_loss is None:
            print("ending training: live population is empty with no "
                  "pending joiners (--churn open-world end state)")
            break
        if np.isnan(train_loss):
            print("TERMINATING TRAINING DUE TO NAN LOSS")
            return
        train_time = timer()
        download_mb = download.sum() / (1024 * 1024)
        upload_mb = upload.sum() / (1024 * 1024)
        total_download += download_mb
        total_upload += upload_mb
        test_loss, test_acc, _, _ = run_batches(model, None, None,
                                                test_loader, False, 1, args)
        test_time = timer()
        epoch_stats = {
            "train_time": train_time,
            "train_loss": train_loss,
            "train_acc": train_acc,
            "test_loss": test_loss,
            "test_acc": test_acc,
            "down (MiB)": round(download_mb),
            "up (MiB)": round(upload_mb),
            "total_time": timer.total_time,
        }
        lr = lr_scheduler.get_last_lr()[0]
        summary = {"epoch": epoch + 1, "lr": lr, **epoch_stats}
        for logger in loggers:
            logger.append(summary)
        if getattr(model, "telemetry", None) is not None:
            model.telemetry.event(
                "epoch", epoch=epoch + 1, lr=float(lr),
                **{k.split(" ")[0]: float(v)
                   for k, v in epoch_stats.items()})
        maybe_save_run_state(args, epoch, model, opt, lr_scheduler,
                             (total_download, total_upload))
        if writer is not None:
            for key, val in (("Loss/train", train_loss),
                             ("Loss/test", test_loss),
                             ("Acc/train", train_acc),
                             ("Acc/test", test_acc),
                             ("Time/train", train_time),
                             ("Time/test", test_time),
                             ("Time/total", timer.total_time),
                             ("Lr", lr)):
                writer.add_scalar(key, val, epoch)
    print(f"Total Download (MiB): {total_download:0.2f}")
    print(f"Total Upload (MiB): {total_upload:0.2f}")
    n = train_loader.dataset.num_clients
    print(f"Avg Download Per Client: {total_download / n:0.2f}")
    print(f"Avg Upload Per Client: {total_upload / n:0.2f}")
    return summary


def build_model_and_config(args):
    """The model of ``--model`` (the JAX package's ``model_config``).

    ResNet9 widths: one channel each and a 1 x 10 sketch with k = 10 under
    ``--test``, ``COMMEFFICIENT_MODEL_CHANNELS`` ("prep,l1,l2,l3"), or
    ``COMMEFFICIENT_TINY_MODEL`` (8,16,16,32), else full width. Under
    ``--finetune`` the classes are ``--finetuned_from``'s and the new head
    ``--dataset_name``'s (``new_num_classes``, which only ResNet9 takes).
    The stem takes the dataset's channels (1 for EMNIST, else 3). Options
    a model's signature does not name are dropped, as the JAX package
    drops them."""
    if getattr(args, "do_test", False):
        model_config = {"channels": (("prep", 1), ("layer1", 1),
                                     ("layer2", 1), ("layer3", 1))}
        args.num_cols = 10
        args.num_rows = 1
        args.k = 10
    elif os.environ.get("COMMEFFICIENT_MODEL_CHANNELS"):
        pre, l1, l2, l3 = (int(x) for x in os.environ[
            "COMMEFFICIENT_MODEL_CHANNELS"].split(","))
        model_config = {"channels": (("prep", pre), ("layer1", l1),
                                     ("layer2", l2), ("layer3", l3))}
    elif os.environ.get("COMMEFFICIENT_TINY_MODEL"):
        model_config = {"channels": (("prep", 8), ("layer1", 16),
                                     ("layer2", 16), ("layer3", 32))}
    else:
        model_config = {}
    if getattr(args, "do_finetune", False):
        model_config["num_classes"] = num_classes_of_dataset(
            args.finetuned_from)
        model_config["new_num_classes"] = num_classes_of_dataset(
            args.dataset_name)
    else:
        model_config["num_classes"] = num_classes_of_dataset(
            args.dataset_name)
    model_config["initial_channels"] = 1 if args.dataset_name == "EMNIST" \
        else 3
    model_cls = getattr(models, getattr(args, "model", "ResNet9"))
    accepted = inspect.signature(model_cls).parameters
    if "do_batchnorm" in accepted:
        model_config["do_batchnorm"] = bool(getattr(args, "do_batchnorm",
                                                    False))
    return model_cls(**{k: v for k, v in model_config.items()
                        if k in accepted})


def build_param_groups(args, layout: ParamLayout):
    """Fixup's per-group LRs and finetune's head-only training as
    ``(mask, base_lr)`` pairs over the flat vector, the JAX package's
    ``build_param_groups`` mask for mask: a leaf's key is its lowercase
    '/'-joined flax path. Fixup: ``bias`` in the key 0.1, ``scale`` or
    ``mul`` 0.1, the rest 1.0. Finetune: ``linear`` or ``classifier`` in
    the key, or a key ending in ``fc``, 1.0, the rest 0. (A key is a
    leaf's full path, ``fc/kernel``, so that last test never matches: the
    resnets' ``fc`` head trains at 0 under ``--finetune`` in both
    packages.) None for a single default group."""

    def mask_for(pred):
        mask = np.zeros(layout.d, bool)
        for e in layout.entries:
            if pred("/".join(e.jax_path).lower()):
                mask[e.offset:e.offset + e.size] = True
        return mask

    if args.model.startswith("Fixup"):
        bias = mask_for(lambda k: "bias" in k)
        scale = mask_for(lambda k: "scale" in k or "mul" in k)
        other = ~(bias | scale)
        return [(bias, 0.1), (scale & ~bias, 0.1), (other, 1.0)]
    if getattr(args, "do_finetune", False):
        head = mask_for(lambda k: "linear" in k or "classifier" in k
                        or k.endswith("fc"))
        return [(head, 1.0), (~head, 0.0)]
    return None


def finetune_init(args, model, layout: ParamLayout) -> torch.Tensor:
    """The finetune start: a fresh init from ``--seed`` with every leaf
    of ``<finetune_path>/<model>.npz`` whose path and shape match loaded
    over it. Returns the flat weights."""
    init_model_(model, args.seed)
    template = flax_from_port(dict(model.named_parameters()), layout)
    ckpt_params, _ = load_checkpoint(os.path.join(args.finetune_path,
                                                  args.model))
    tree, loaded, skipped = load_matching(template, ckpt_params)
    print(f"finetune: loaded {loaded} tensors, fresh: {skipped}")
    return layout.flatten(params_from_flax(tree, layout))


def open_writer(args, log_dir: str):
    """``--tensorboard``: a ``SummaryWriter`` in the run dir, or None
    (console logging only) where ``torch.utils.tensorboard`` cannot be
    imported, as in the JAX package."""
    if not args.use_tensorboard:
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        print("tensorboard unavailable; console logging only")
        return None
    return SummaryWriter(log_dir=log_dir)


def check_trainable(model) -> None:
    """A model with BatchNorm that ``--batchnorm`` does not gate raises:
    the JAX package's ``cv_train`` cannot train it (``has_bn``,
    cv_train.py:429, is False for it, and flax then finds no
    ``batch_stats``); ROADMAP.md queue 3 records it. The port's modules
    carry its statistics (``initial_model_state``)."""
    if model.initial_model_state() and not isinstance(model, ResNet9):
        raise NotImplementedError(
            f"{type(model).__name__} has BatchNorm that --batchnorm does "
            "not gate: the JAX package's cv_train cannot train it (its "
            "has_bn, cv_train.py:429, is False and flax finds no "
            "batch_stats), so neither does the port (ROADMAP.md queue 3)")


def check_no_seq_parallel(args) -> None:
    """``--seq_parallel`` is GPT-2's: a CV batch has no sequence to split,
    so each seq rank would compute the whole gradient, and the sum over
    the seq axis multiplies it by the axis size. The JAX package's
    ``cv_train`` takes the flag and trains on that scaled gradient; the
    port refuses it (ROADMAP.md queue 3)."""
    if getattr(args, "seq_parallel", "none") != "none":
        raise ValueError(
            f"--seq_parallel {args.seq_parallel} splits GPT-2's sequence; "
            "cv_train has no sequence to split (under the flag the JAX "
            "package's cv_train sums each seq rank's whole gradient, "
            "scaling it by --seq_devices), so the port refuses it")


def main(argv=None, init_method=None):
    """``init_method``: the process group's rendezvous under ``torchrun``
    (default ``env://``)."""
    args = parse_args(argv=argv)
    # tensor parallelism, the pipeline and experts are GPT-2's (the JAX
    # package's assertions)
    assert args.model_devices == 1, (
        "--model_devices (tensor parallelism) is GPT-2 only; the CV models "
        "have no model axis — use gpt2_train.py")
    assert args.pipeline_devices == 1, (
        "--pipeline_devices (pipeline parallelism) is GPT-2 only; the CV "
        "models have no stage axis — use gpt2_train.py")
    assert args.n_experts == 0, (
        "--n_experts (MoE / expert parallelism) is GPT-2 only; the CV "
        "models have no expert axis — use gpt2_train.py")
    check_no_seq_parallel(args)
    group = start_client_group(args, init_method)
    try:
        if group is not None and not group.active:
            print(f"rank {group.rank} idle: the client group has "
                  f"{group.size} ranks")
            return None
        return _main(args, group)
    finally:
        if group is not None:
            destroy_distributed()


def _main(args, group):
    quiet_unless_main()
    device = resolve_device(group.device if group is not None
                            else args.device)
    set_fp32_numerics()
    if args.lr_scale is None:
        args.lr_scale = 0.4  # cifar10-fast default peak LR
    print(args)
    sync = torch.cuda.synchronize if device.type == "cuda" else None
    timer = Timer(synch=sync)
    np.random.seed(args.seed)

    model = build_model_and_config(args)
    check_trainable(model)
    train_loader, test_loader = main_first(lambda: get_data_loaders(args))
    compute_loss_train, compute_loss_val = make_cv_losses(
        model, compute_dtype=torch.bfloat16 if args.do_bf16 else None)
    layout = ParamLayout(model)
    init_params = (finetune_init(args, model, layout) if args.do_finetune
                   else None)
    fed_model = FedModel(model, compute_loss_train, args, compute_loss_val,
                         num_clients=train_loader.dataset.num_clients,
                         init_params=init_params, device=device,
                         group=group)
    opt = FedOptimizer(fed_model, args,
                       param_groups=build_param_groups(args, layout))
    # the participation layer (--participation, --inject_client_fault,
    # --async_buffer): the sampler's cohorts, faults, late landing
    pc = attach_participation(args, fed_model,
                              sampler=getattr(train_loader, "sampler", None))
    # the open-world population (--churn): the sampler draws from the live
    # population; the disk tier's rows follow it
    pm = attach_churn(args, fed_model,
                      sampler=getattr(train_loader, "sampler", None))
    lr_schedule = PiecewiseLinear([0, args.pivot_epoch, args.num_epochs],
                                  [0, args.lr_scale, 0])
    spe = train_loader.steps_per_epoch()
    lr_scheduler = LambdaLR(opt, lr_lambda=lambda step: lr_schedule(step / spe))
    log_dir = make_logdir(args)
    writer = open_writer(args, log_dir) if fed_model.is_main else None
    # the telemetry plane (on by default): the metric vectors and the run
    # event log <log_dir>/telemetry.jsonl, and the round tracer
    rt = attach_run_telemetry(args, fed_model, log_dir, "cv_train")
    start_epoch, totals, resume_mid = resume_run(args, fed_model, opt,
                                                 lr_scheduler)
    if rt is not None and (start_epoch or resume_mid is not None):
        rt.event("resume", start_epoch=start_epoch,
                 mid_epoch=resume_mid is not None)
    print(f"Finished initializing in {timer():.2f} seconds")
    try:
        summary = train(fed_model, opt, lr_scheduler, train_loader,
                        test_loader, args, loggers=(TableLogger(),),
                        timer=timer, start_epoch=start_epoch, totals=totals,
                        resume_mid=resume_mid, writer=writer)
    finally:
        expire_participation(pc, rt)
        audit_churn(pm, rt)
        close_run_telemetry(fed_model, rt)
        if writer is not None:
            writer.close()
        fed_model.finalize()
    if args.do_checkpoint and fed_model.is_main:
        os.makedirs(args.checkpoint_path, exist_ok=True)
        save_checkpoint(os.path.join(args.checkpoint_path, args.model),
                        flax_from_port(fed_model.params,
                                       fed_model.param_layout),
                        fed_model._model_state)
    return summary


if __name__ == "__main__":
    main()
