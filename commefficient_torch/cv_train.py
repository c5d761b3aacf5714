"""CV federated training entry point of the port (ResNet9 on CIFAR10/100,
sketch mode).

    python -m commefficient_torch.cv_train --dataset_name CIFAR10 \
        --dataset_dir ./dataset --mode sketch --error_type virtual \
        --local_momentum 0 --virtual_momentum 0.9 --num_workers 8 \
        --num_clients 1000 --iid --num_epochs 24

CLI and loop parity with ``cv_train.py`` of the JAX package: the same flags
(config.py), a ``PiecewiseLinear`` LR peaking at ``--pivot_epoch``, the NaN
abort, per-epoch ``TableLogger`` rows and byte totals. The loop is plain
and synchronous, in the JAX engine's order: ``lr_scheduler.step();
model(batch); opt.step()``. Runs on ``cuda`` unless ``--device cpu``;
float32 throughout (TF32 off).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from commefficient_torch import models
from commefficient_torch.config import parse_args
from commefficient_torch.data_utils import (
    FedCIFAR10,
    FedCIFAR100,
    FedLoader,
    num_classes_of_dataset,
    transforms,
)
from commefficient_torch.federated import FedModel, FedOptimizer, LambdaLR
from commefficient_torch.federated.aggregator import (
    resolve_device,
    set_fp32_numerics,
)
from commefficient_torch.federated.losses import make_cv_losses
from commefficient_torch.utils import (
    PiecewiseLinear,
    TableLogger,
    Timer,
)


def get_data_loaders(args):
    train_transforms, val_transforms = {
        "CIFAR10": (transforms.cifar10_train_transforms,
                    transforms.cifar10_test_transforms),
        "CIFAR100": (transforms.cifar100_train_transforms,
                     transforms.cifar100_test_transforms),
    }[args.dataset_name]
    dataset_class = {"CIFAR10": FedCIFAR10,
                     "CIFAR100": FedCIFAR100}[args.dataset_name]
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
    return train_loader, test_loader


def run_batches(model, opt, lr_scheduler, loader, training, epoch_fraction,
                args):
    if not training and epoch_fraction != 1:
        raise ValueError("Must do full epochs for val")
    model.train(training)
    losses, accs = [], []
    if training:
        num_clients = loader.dataset.num_clients
        client_download = np.zeros(num_clients)
        client_upload = np.zeros(num_clients)
        spe = loader.steps_per_epoch()
        for i, batch in enumerate(loader):
            if i > spe * epoch_fraction:
                break
            lr_scheduler.step()
            loss, acc, download, upload = model(batch)
            opt.step()
            if np.any(np.isnan(loss)):
                print(f"LOSS OF {np.mean(loss)} IS NAN, TERMINATING TRAINING")
                return np.nan, np.nan, np.nan, np.nan
            client_download += download
            client_upload += upload
            losses.extend(loss.tolist())
            accs.extend(acc.tolist())
        return (np.mean(losses), np.mean(accs), client_download,
                client_upload)
    for batch in loader:
        loss, acc = model(batch)
        losses.extend(loss.tolist())
        accs.extend(acc.tolist())
    return np.mean(losses), np.mean(accs), None, None


def train(model, opt, lr_scheduler, train_loader, test_loader, args,
          loggers=(), timer=None):
    timer = timer or Timer()
    total_download, total_upload = 0.0, 0.0
    if args.eval_before_start:
        _, test_acc, _, _ = run_batches(model, None, None, test_loader,
                                        False, 1, args)
        timer()
        print(f"Test acc at epoch 0: {test_acc:0.4f}")
    summary = {}
    for epoch in range(math.ceil(args.num_epochs)):
        if epoch == math.ceil(args.num_epochs) - 1:
            epoch_fraction = args.num_epochs - epoch
        else:
            epoch_fraction = 1
        train_loss, train_acc, download, upload = run_batches(
            model, opt, lr_scheduler, train_loader, True, epoch_fraction,
            args)
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
        timer()
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
    print(f"Total Download (MiB): {total_download:0.2f}")
    print(f"Total Upload (MiB): {total_upload:0.2f}")
    n = train_loader.dataset.num_clients
    print(f"Avg Download Per Client: {total_download / n:0.2f}")
    print(f"Avg Upload Per Client: {total_upload / n:0.2f}")
    return summary


def build_model_and_config(args):
    """ResNet9 widths: ``COMMEFFICIENT_MODEL_CHANNELS`` ("prep,l1,l2,l3")
    or ``COMMEFFICIENT_TINY_MODEL`` (8,16,16,32), else full width."""
    if os.environ.get("COMMEFFICIENT_MODEL_CHANNELS"):
        pre, l1, l2, l3 = (int(x) for x in os.environ[
            "COMMEFFICIENT_MODEL_CHANNELS"].split(","))
        model_config = {"channels": (("prep", pre), ("layer1", l1),
                                     ("layer2", l2), ("layer3", l3))}
    elif os.environ.get("COMMEFFICIENT_TINY_MODEL"):
        model_config = {"channels": (("prep", 8), ("layer1", 16),
                                     ("layer2", 16), ("layer3", 32))}
    else:
        model_config = {}
    model_config["num_classes"] = num_classes_of_dataset(args.dataset_name)
    return getattr(models, args.model)(**model_config)


def main(argv=None):
    args = parse_args(argv=argv)
    device = resolve_device(args.device)
    set_fp32_numerics()
    if args.lr_scale is None:
        args.lr_scale = 0.4  # cifar10-fast default peak LR
    print(args)
    sync = torch.cuda.synchronize if device.type == "cuda" else None
    timer = Timer(synch=sync)
    np.random.seed(args.seed)

    model = build_model_and_config(args)
    train_loader, test_loader = get_data_loaders(args)
    compute_loss_train, compute_loss_val = make_cv_losses(model)
    fed_model = FedModel(model, compute_loss_train, args, compute_loss_val,
                         num_clients=train_loader.dataset.num_clients,
                         device=device)
    opt = FedOptimizer(fed_model, args)
    lr_schedule = PiecewiseLinear([0, args.pivot_epoch, args.num_epochs],
                                  [0, args.lr_scale, 0])
    spe = train_loader.steps_per_epoch()
    lr_scheduler = LambdaLR(opt, lr_lambda=lambda step: lr_schedule(step / spe))
    print(f"Finished initializing in {timer():.2f} seconds")
    try:
        summary = train(fed_model, opt, lr_scheduler, train_loader,
                        test_loader, args, loggers=(TableLogger(),),
                        timer=timer)
    finally:
        fed_model.finalize()
    return summary


if __name__ == "__main__":
    main()
