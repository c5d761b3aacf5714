"""CLI surface of the port: its own copy of the flags the sketched ResNet9
slice reads, with the JAX package's names and defaults
(``commefficient_tpu/config.py``).

Deviations: ``--device`` takes ``{cuda, cpu}`` with ``cuda`` the default
(a CUDA request on a host without a card raises; there is no fallback to
the CPU), and the run is on one device (``--num_devices`` -1 or 1).

Every flag of the JAX package that this slice does not carry is still
parsed, so that using it raises ``NotImplementedError`` naming the ROADMAP
item that ports it instead of being ignored (``reject_unported``).
``--no_telemetry`` is accepted: the port has no telemetry plane yet.
"""

from __future__ import annotations

import argparse

MODES = ["sketch", "true_topk", "local_topk", "fedavg", "uncompressed"]
ERROR_TYPES = ["none", "local", "virtual"]
DATASETS = ["CIFAR10", "CIFAR100"]

_Q1 = "ROADMAP.md queue 1"
ITEM_MODES = f"{_Q1} item 1 (the other server modes and the per-client worker path)"
ITEM_OPT_IN = f"{_Q1} item 2 (the opt-in sketch paths, queue 2 kernels 2, 4, 6)"
ITEM_CKPT = f"{_Q1} item 3 (checkpoint, resume and the round engine)"
ITEM_CV = f"{_Q1} item 4 (the other CV models, datasets and data planes)"
ITEM_GPT2 = f"{_Q1} item 5 (GPT-2 and --bf16)"
ITEM_MULTI = f"{_Q1} item 6 (multi-GPU)"
ITEM_RUNTIME = f"{_Q1} item 7 (runtime planes)"

# (flag, dest, takes a value, roadmap item)
UNPORTED = (
    ("--test", "do_test", False, ITEM_MODES),
    ("--bf16", "do_bf16", False, ITEM_GPT2),
    ("--tensorboard", "use_tensorboard", False, ITEM_RUNTIME),
    ("--profile", "do_profile", False, ITEM_RUNTIME),
    ("--finetune", "do_finetune", False, ITEM_CV),
    ("--finetuned_from", "finetuned_from", True, ITEM_CV),
    ("--finetune_path", "finetune_path", True, ITEM_CV),
    ("--checkpoint", "do_checkpoint", False, ITEM_CKPT),
    ("--checkpoint_every", "checkpoint_every", True, ITEM_CKPT),
    ("--checkpoint_every_rounds", "checkpoint_every_rounds", True, ITEM_CKPT),
    ("--resume", "resume", True, ITEM_CKPT),
    ("--keep_checkpoints", "keep_checkpoints", True, ITEM_CKPT),
    ("--state_dir", "state_dir", True, ITEM_RUNTIME),
    ("--batchnorm", "do_batchnorm", False, ITEM_MODES),
    ("--topk_down", "do_topk_down", False, ITEM_MODES),
    ("--num_fedavg_epochs", "num_fedavg_epochs", True, ITEM_MODES),
    ("--fedavg_batch_size", "fedavg_batch_size", True, ITEM_MODES),
    ("--fedavg_lr_decay", "fedavg_lr_decay", True, ITEM_MODES),
    ("--dp", "do_dp", False, ITEM_MODES),
    ("--round_window", "round_window", True, ITEM_CKPT),
    ("--metrics_drain_every", "metrics_drain_every", True, ITEM_CKPT),
    ("--server_shard", "server_shard", False, ITEM_MULTI),
    ("--shard_devices", "shard_devices", True, ITEM_MULTI),
    ("--reduce_dtype", "reduce_dtype", True, ITEM_MULTI),
    ("--collective_plan", "collective_plan", True, ITEM_MULTI),
    ("--fused_epilogue", "fused_epilogue", False, ITEM_OPT_IN),
    ("--stream_sketch", "stream_sketch", False, ITEM_OPT_IN),
    ("--sketch_coalesce", "sketch_coalesce", False, ITEM_OPT_IN),
    ("--seq_parallel", "seq_parallel", True, ITEM_GPT2),
    ("--model_devices", "model_devices", True, ITEM_GPT2),
    ("--pipeline_devices", "pipeline_devices", True, ITEM_GPT2),
    ("--n_experts", "n_experts", True, ITEM_GPT2),
    ("--client_dropout", "client_dropout", True, ITEM_RUNTIME),
    ("--participation", "participation", True, ITEM_RUNTIME),
    ("--inject_client_fault", "inject_client_fault", True, ITEM_RUNTIME),
    ("--churn", "churn", True, ITEM_RUNTIME),
    ("--async_buffer", "async_buffer", True, ITEM_RUNTIME),
    ("--telemetry", "telemetry", False, ITEM_RUNTIME),
    ("--watch_rules", "watch_rules", True, ITEM_RUNTIME),
    ("--trace_rounds", "trace_rounds", True, ITEM_RUNTIME),
    ("--guards", "guards", False, ITEM_RUNTIME),
    ("--inject_io_fault", "inject_io_fault", True, ITEM_RUNTIME),
    ("--inject_fault", "inject_fault", True, ITEM_RUNTIME),
)


def build_parser(default_lr=None) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--mode", choices=MODES, default="sketch")
    parser.add_argument("--seed", type=int, default=21)
    parser.add_argument("--model", default="ResNet9", choices=["ResNet9"],
                        help="Name of the model.")
    parser.add_argument("--dataset_name", type=str, default="",
                        choices=DATASETS + [""])
    parser.add_argument("--dataset_dir", type=str, default="./dataset")

    # compression
    parser.add_argument("--k", type=int, default=50000)
    parser.add_argument("--num_cols", type=int, default=500000)
    parser.add_argument("--num_rows", type=int, default=5)
    parser.add_argument("--num_blocks", type=int, default=20)

    # optimization
    parser.add_argument("--local_momentum", type=float, default=0.9)
    parser.add_argument("--virtual_momentum", type=float, default=0)
    parser.add_argument("--weight_decay", type=float, default=5e-4)
    parser.add_argument("--num_epochs", type=float, default=24)
    parser.add_argument("--error_type", choices=ERROR_TYPES, default="none")
    parser.add_argument("--lr_scale", type=float, default=default_lr)
    parser.add_argument("--pivot_epoch", type=float, default=5)

    # clients and device
    parser.add_argument("--num_clients", type=int)
    parser.add_argument("--num_workers", type=int, default=1,
                        help="Clients sampled per round.")
    parser.add_argument("--device", type=str, choices=["cuda", "cpu"],
                        default="cuda",
                        help="cuda (default; raises without a card) or cpu.")
    parser.add_argument("--num_devices", type=int, default=-1,
                        help="The port runs on one device: -1 or 1.")
    parser.add_argument("--iid", action="store_true", dest="do_iid")
    parser.add_argument("--train_dataloader_workers", type=int, default=0)
    parser.add_argument("--val_dataloader_workers", type=int, default=0)
    parser.add_argument("--local_batch_size", type=int, default=8)
    parser.add_argument("--valid_batch_size", type=int, default=8)
    parser.add_argument("--microbatch_size", type=int, default=-1)
    parser.add_argument("--max_grad_norm", type=float)
    parser.add_argument("--eval_before_start", action="store_true")
    parser.add_argument("--no_telemetry", action="store_false",
                        dest="telemetry", default=False,
                        help="Accepted; the port has no telemetry plane.")

    for flag, dest, valued, _item in UNPORTED:
        if valued:
            parser.add_argument(flag, type=str, dest=dest, default=None,
                                help="Not ported yet.")
        else:
            parser.add_argument(flag, action="store_true", dest=dest,
                                default=False, help="Not ported yet.")
    return parser


def reject_unported(args) -> None:
    """Raise ``NotImplementedError`` for any option this slice does not
    carry. Attributes an ``args`` object lacks count as unset."""
    for flag, dest, valued, item in UNPORTED:
        val = getattr(args, dest, None)
        if (val is not None) if valued else bool(val):
            raise NotImplementedError(f"{flag} is not ported yet ({item})")
    if getattr(args, "mode", "sketch") != "sketch":
        raise NotImplementedError(
            f"--mode {args.mode} is not ported yet ({ITEM_MODES})")
    if getattr(args, "model", "ResNet9") != "ResNet9":
        raise NotImplementedError(
            f"--model {args.model} is not ported yet ({ITEM_CV})")
    if getattr(args, "num_devices", -1) not in (-1, 1):
        raise NotImplementedError(
            f"--num_devices {args.num_devices}: the port runs on one device "
            f"({ITEM_MULTI})")
    for name in ("train_dataloader_workers", "val_dataloader_workers"):
        if getattr(args, name, 0):
            raise NotImplementedError(
                f"--{name} > 0 (the prefetch loader) is not ported yet "
                f"({ITEM_CV})")


def parse_args(default_lr=None, argv=None):
    args = build_parser(default_lr).parse_args(argv)
    reject_unported(args)
    return args
