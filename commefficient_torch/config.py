"""CLI surface of the port: its own copy of the flags the CV and GPT-2
rounds read (all five ``--mode`` values, every model of the registry,
CIFAR10/100, EMNIST, ImageNet and PersonaChat), with the JAX package's
names and defaults (``commefficient_tpu/config.py``), and its fedavg
invariants. ``cv_train`` carries ``--finetune``, ``--finetuned_from``
and ``--finetune_path``; ``gpt2_train`` ``--finetune`` and
``--finetune_path`` (the JAX package's eval-only path).
``--train_dataloader_workers`` / ``--val_dataloader_workers`` > 0 wrap
the loaders in ``PrefetchLoader``.

GPT-2's flags (``gpt2_train``): ``--model_checkpoint`` (a local
directory of HF weights, ``pytorch_model.bin`` or ``model.safetensors``,
or a saved run dir's ``model.npz``; nothing is downloaded),
``--num_candidates``, ``--max_history``, ``--lm_coef``, ``--mc_coef``,
``--personality_permutations``, ``--max_seq_len`` (256, or
``COMMEFFICIENT_GPT2_SEQ_LEN``), ``--eval_before_start`` and ``--bf16``
(the forward and backward in bfloat16 over float32 master weights; the
CV losses take it too).

Deviations: ``--device`` takes ``{cuda, cpu}`` with ``cuda`` the default
(a CUDA request on a host without a card raises; there is no fallback to
the CPU). Under ``torchrun`` (``WORLD_SIZE`` set) each rank is one GPU
(``cuda:LOCAL_RANK``, NCCL; gloo with ``--device cpu``) and the round's
client slots split over ``min(--num_devices, world)`` ranks, reduced to
the largest divisor of ``--num_workers`` (``parallel/mesh.py``);
``--server_shard``, ``--reduce_dtype`` and the flat ``--collective_plan``
forms carry the JAX package's checks. ``--shard_devices > 1``, the
per-axis plans and ``--collective_plan auto`` raise naming queue 1 item
5a.

The opt-in sketch paths ``--stream_sketch``, ``--sketch_coalesce`` and
``--fused_epilogue`` are carried, with the JAX package's notes for
``--stream_sketch`` outside the fused sketch round and for
``--sketch_coalesce`` without ``--stream_sketch`` (no-ops there).

The run lifecycle is carried too: ``--batchnorm``, the checkpoint and
resume flags (``--checkpoint``, ``--checkpoint_path``,
``--checkpoint_every``, ``--checkpoint_every_rounds``, ``--resume``,
``--keep_checkpoints``) and the round engine's ``--round_window`` and
``--metrics_drain_every``, with the JAX package's names, defaults and
help.

The observability plane and the health guards are carried with the JAX
package's names, defaults and help: ``--telemetry`` / ``--no_telemetry``,
``--telemetry_hist`` / ``--no_telemetry_hist`` and ``--watch`` /
``--no_watch`` (all on by default), ``--watch_rules``, ``--trace_rounds``,
``--tensorboard``, ``--profile`` / ``--profile_dir`` / ``--profile_steps``,
``--guards``, ``--guard_max_abs``, ``--snapshot_every``,
``--max_guard_trips`` and ``--inject_fault`` (``parse_inject_fault``).

Per-client state off the card (``federated/memory.py``,
``federated/host_state.py``) is carried with the JAX package's names,
defaults, help and checks (``check_host_state``): ``--state_dir``,
``--inject_io_fault``, ``--io_retries``, ``--io_backoff_ms``,
``--io_deadline_ms``, ``--io_queue_bound``, ``--io_checksums`` /
``--no_io_checksums`` and ``--io_scrub_rows``.

Client participation (``federated/participation.py``) is carried with
the JAX package's names, defaults, help and checks
(``check_participation``): ``--client_dropout``, ``--participation``,
``--participation_sampling``, ``--inject_client_fault``,
``--staleness_decay``, ``--client_retry_limit``, ``--async_buffer`` and
the open-world population's ``--churn``.
``--port``, ``--share_ps_gpu``, ``--nan_threshold`` and
``--num_results_*`` are accepted and ignored, as the JAX package ignores
them; ``--rng_impl threefry2x32`` is a no-op and its JAX-only PRNGs raise.

Every other flag of the JAX package is parsed with its type and default
(``UNPORTED``); a value other than the default raises
``NotImplementedError`` naming the ROADMAP item that ports it
(``reject_unported``).
"""

from __future__ import annotations

import argparse
import os

MODES = ["sketch", "true_topk", "local_topk", "fedavg", "uncompressed"]
ERROR_TYPES = ["none", "local", "virtual"]
DATASETS = ["CIFAR10", "CIFAR100", "EMNIST", "ImageNet", "PERSONA"]
DP_MODES = ["worker", "server"]

_Q1 = "ROADMAP.md queue 1"
ITEM_MULTI_2D = (f"{_Q1} item 5a (the 2-D clients x shard plane, "
                 f"per-axis collective plans, --collective_plan auto, the "
                 f"multi-host seam)")
ITEM_PARALLEL = (f"{_Q1} item 7 (parallel/: sequence, tensor, pipeline "
                 f"and expert parallelism)")

# The flags of planes the port does not carry yet, with the JAX package's
# types and defaults: (option strings, add_argument keywords, item). Each
# is parsed; a value other than its default raises naming the item.
UNPORTED = (
    ("--plan_error_budget", dict(type=float, default=0.05),
     ITEM_MULTI_2D),
    ("--seq_parallel", dict(choices=["none", "ring", "ulysses"],
                            default="none"), ITEM_PARALLEL),
    ("--seq_devices", dict(type=int, default=2), ITEM_PARALLEL),
    ("--model_devices", dict(type=int, default=1), ITEM_PARALLEL),
    ("--pipeline_devices", dict(type=int, default=1), ITEM_PARALLEL),
    ("--pp_microbatches", dict(type=int, default=4), ITEM_PARALLEL),
    ("--n_experts", dict(type=int, default=0), ITEM_PARALLEL),
    ("--expert_devices", dict(type=int, default=1), ITEM_PARALLEL),
    ("--moe_dispatch", dict(choices=["dense", "sparse"], default="dense"),
     ITEM_PARALLEL),
    ("--moe_capacity_factor", dict(type=float, default=1.25),
     ITEM_PARALLEL),
    ("--moe_aux_coef", dict(type=float, default=0.01), ITEM_PARALLEL),
)


def _unported_defaults():
    """``(flag, dest, default, item)`` for every unported value: a
    ``store_false`` twin names itself, since only it moves the value off
    its default."""
    out = {}
    for flag, kw, item in UNPORTED:
        dest = kw.get("dest", flag.lstrip("-"))
        if kw.get("action") == "store_false":
            out[dest] = (flag, dest, out[dest][2], item)
        else:
            out[dest] = (flag, dest, kw.get("default"), item)
    return tuple(out.values())


def parse_inject_fault(spec: str):
    """``--inject_fault`` spec -> {round_index: poison_value}. The spec is
    'ROUND:KIND[,ROUND:KIND...]' with KIND in {nan, inf}; a malformed spec
    fails here at parse time, not rounds into a run."""
    values = {"nan": float("nan"), "inf": float("inf")}
    out = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            rnd, kind = part.split(":")
            rnd = int(rnd)
        except ValueError:
            raise ValueError(
                f"--inject_fault: bad entry {part!r}; expected ROUND:KIND "
                f"(e.g. '5:nan' or '2:nan,7:inf')") from None
        assert kind in values, (
            f"--inject_fault: unknown kind {kind!r}; use nan|inf")
        assert rnd >= 0, f"--inject_fault: round {rnd} must be >= 0"
        out[rnd] = values[kind]
    return out


def _model_names():
    """The registry: the model names of ``commefficient_torch.models`` that
    start with a capital (the JAX package's rule)."""
    from commefficient_torch import models

    return [m for m in dir(models)
            if not m.startswith("__") and m[0].isupper()]


def build_parser(default_lr=None) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--mode", choices=MODES, default="sketch")
    parser.add_argument("--test", action="store_true", dest="do_test")
    parser.add_argument("--seed", type=int, default=21)
    parser.add_argument("--model", default="ResNet9", choices=_model_names(),
                        help="Name of the model.")
    parser.add_argument("--finetune", action="store_true", dest="do_finetune")
    parser.add_argument("--finetune_path", type=str, default="./finetune")
    parser.add_argument("--finetuned_from", type=str, choices=DATASETS,
                        help="Name of the dataset you pretrained on.")
    parser.add_argument("--state_dir", type=str, default="",
                        help="Backing directory for disk-tier per-client "
                             "state (the sparse row store). Default: a "
                             "client_state/ directory under "
                             "--checkpoint_path. Only used when the "
                             "memory plan resolves the disk placement "
                             "tier.")
    parser.add_argument("--dataset_name", type=str, default="",
                        choices=DATASETS + [""])
    parser.add_argument("--dataset_dir", type=str, default="./dataset")

    # compression
    parser.add_argument("--k", type=int, default=50000)
    parser.add_argument("--num_cols", type=int, default=500000)
    parser.add_argument("--num_rows", type=int, default=5)
    parser.add_argument("--num_blocks", type=int, default=20)
    parser.add_argument("--topk_down", action="store_true", dest="do_topk_down")

    # optimization
    parser.add_argument("--local_momentum", type=float, default=0.9)
    parser.add_argument("--virtual_momentum", type=float, default=0)
    parser.add_argument("--weight_decay", type=float, default=5e-4)
    parser.add_argument("--num_epochs", type=float, default=24)
    parser.add_argument("--num_fedavg_epochs", type=int, default=1)
    parser.add_argument("--fedavg_batch_size", type=int, default=-1)
    parser.add_argument("--fedavg_lr_decay", type=float, default=1)
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
                        help="Ranks of the client group under torchrun; "
                             "-1 = the world.")
    # the sharded server data plane and its collectives (the JAX
    # package's flags; the flat plans)
    parser.add_argument("--server_shard", action="store_true",
                        dest="server_shard",
                        help="Shard the server aggregation/update over the "
                             "client group (reduce-scatter -> per-shard "
                             "update -> all-gather).")
    parser.add_argument("--shard_devices", type=int, default=1,
                        help="The 2-D (clients x shard) plane: not ported, "
                             "only 1.")
    parser.add_argument("--reduce_dtype", choices=["float32", "int8"],
                        default="float32",
                        help="Legacy alias of --collective_plan: int8 sets "
                             "every wire leg to the block-scaled "
                             "stochastic-rounding collectives; requires "
                             "--server_shard.")
    parser.add_argument("--collective_plan", type=str, default="",
                        help="Per-leg wire dtypes: 'leg=dtype,...' over "
                             "legs {uplink,table,downlink} and dtypes "
                             "{fp32,int8,fp8_e4m3,int4} (unnamed legs stay "
                             "fp32), or one bare dtype for every leg. "
                             "Quantized legs require --server_shard.")

    parser.add_argument("--iid", action="store_true", dest="do_iid")
    parser.add_argument("--train_dataloader_workers", type=int, default=0)
    parser.add_argument("--val_dataloader_workers", type=int, default=0)
    parser.add_argument("--local_batch_size", type=int, default=8)
    parser.add_argument("--valid_batch_size", type=int, default=8)
    parser.add_argument("--microbatch_size", type=int, default=-1)
    parser.add_argument("--max_grad_norm", type=float)
    parser.add_argument("--eval_before_start", action="store_true")

    # differential privacy
    parser.add_argument("--dp", action="store_true", dest="do_dp")
    parser.add_argument("--dp_mode", choices=DP_MODES, default="worker")
    parser.add_argument("--l2_norm_clip", type=float, default=1.0)
    parser.add_argument("--noise_multiplier", type=float, default=0.0)

    parser.add_argument("--batchnorm", action="store_true",
                        dest="do_batchnorm")
    parser.add_argument("--bf16", action="store_true", dest="do_bf16",
                        help="Forward and backward in bfloat16; master "
                             "weights, compression and the server stay "
                             "float32.")

    # GPT-2 (the JAX package's flags)
    parser.add_argument("--model_checkpoint", type=str, default="gpt2")
    parser.add_argument("--num_candidates", type=int, default=2)
    parser.add_argument("--max_history", type=int, default=2)
    parser.add_argument("--lm_coef", type=float, default=1.0)
    parser.add_argument("--mc_coef", type=float, default=1.0)
    parser.add_argument("--personality_permutations", type=int, default=1)
    parser.add_argument("--max_seq_len", type=int,
                        default=int(os.environ.get(
                            "COMMEFFICIENT_GPT2_SEQ_LEN", 256)),
                        help="GPT-2 static sequence length (pad/left-"
                             "truncate PersonaChat examples to this).")

    # checkpoint, resume and the round engine (the JAX package's flags)
    parser.add_argument("--checkpoint", action="store_true",
                        dest="do_checkpoint")
    parser.add_argument("--checkpoint_path", type=str,
                        default="./checkpoint")
    parser.add_argument("--checkpoint_every", type=int, default=0,
                        help="Save full run state every N epochs (0 = off).")
    parser.add_argument("--checkpoint_every_rounds", type=int, default=0,
                        help="Save full run state every N rounds mid-epoch "
                             "(0 = off; engine in-flight window is drained "
                             "before each save).")
    parser.add_argument("--resume", type=str, default="",
                        help="Path of a run-state checkpoint to resume "
                             "from, or 'auto' to pick the newest VALID "
                             "run_state*.npz under --checkpoint_path "
                             "(corrupt/truncated files are skipped).")
    parser.add_argument("--keep_checkpoints", type=int, default=0,
                        help="Retain only the newest N run_state*.npz under "
                             "--checkpoint_path, pruning older ones after "
                             "each save (0 = keep all; existing workflows "
                             "unchanged).")
    parser.add_argument("--round_window", type=int, default=2,
                        help="Max rounds dispatched ahead of device "
                             "completion (pipelined round engine).")
    parser.add_argument("--metrics_drain_every", type=int, default=8,
                        help="Fetch per-round metrics in batches of N "
                             "rounds; 1 restores per-round (blocking) "
                             "metric fetching.")

    # opt-in sketch paths (the JAX package's flags)
    parser.add_argument("--fused_epilogue", action="store_true",
                        dest="fused_epilogue",
                        help="Mask at the top-k threshold, emit the update "
                             "and re-sketch it in one kernel sweep (sketch "
                             "mode; the composed path stays the default).")
    parser.add_argument("--stream_sketch", action="store_true",
                        dest="stream_sketch",
                        help="Sketch the client phase's gradient leaf by "
                             "leaf into a running table instead of "
                             "forming the flat d-vector.")
    parser.add_argument("--sketch_coalesce", action="store_true",
                        dest="sketch_coalesce",
                        help="Accumulate each group of adjacent gradient "
                             "leaves with one launch (requires "
                             "--stream_sketch).")

    # client participation, faults, late landing and async buffering
    # (federated/participation.py; the JAX package's flags and help)
    parser.add_argument("--client_dropout", type=float, default=0.0,
                        help="Per-round probability that a sampled client "
                             "drops out (0 disables).")
    parser.add_argument("--participation", type=str, default="",
                        help="Per-round cohort as a fraction of "
                             "--num_workers in (0,1] or an absolute client "
                             "count; unused worker slots are zero-masked "
                             "and the data-weighted round mean makes the "
                             "missing clients an exact reweighting. Empty "
                             "= full participation (bit-identical legacy "
                             "path).")
    parser.add_argument("--participation_sampling",
                        choices=["uniform", "weighted", "stratified"],
                        default="uniform",
                        help="Cohort draw for --participation: uniform "
                             "(legacy np.random.choice), weighted "
                             "(probability ~ remaining items), or "
                             "stratified (one pick per remaining-size "
                             "stratum).")
    parser.add_argument("--inject_client_fault", type=str, default="",
                        help="Debug: seeded per-client fault schedule "
                             "'drop=P,slow=P,corrupt=P,delay=N,seed=N,"
                             "quarantine_after=N' — per round each live "
                             "slot independently drops (items requeued "
                             "with bounded retries), straggles (transmit "
                             "lands delay rounds late with the staleness "
                             "decay), or is corrupted (masked out BEFORE "
                             "the round sum — the guard never trips; "
                             "repeat offenders are client-quarantined).")
    parser.add_argument("--staleness_decay", type=float, default=0.5,
                        help="Late-landing weight w(delta) = decay**delta "
                             "for straggler cohorts landing delta rounds "
                             "late (1.0 = undecayed).")
    parser.add_argument("--client_retry_limit", type=int, default=3,
                        help="Max requeues per client per epoch for "
                             "dropped-client data before the drop is "
                             "abandoned (participation layer).")
    parser.add_argument("--churn", type=str, default="",
                        help="Seeded population-churn schedule "
                             "'join=R,depart=R,init=F,seed=N,compact=N': "
                             "R = expected clients per round (Poisson "
                             "draws), init = fraction registered at "
                             "round 0, compact = disk-tier hole count "
                             "that triggers checkpoint-time row-store "
                             "compaction. Empty = closed population "
                             "(docs/service.md).")
    parser.add_argument("--async_buffer", type=int, default=0,
                        help="Buffered-asynchronous federation: fold a "
                             "server update whenever K contributions have "
                             "landed instead of once per dispatch; "
                             "contributions carry exact model-version "
                             "staleness and fold with w(delta) = "
                             "--staleness_decay**delta. 0 (default) = "
                             "synchronous rounds (bit-identical legacy "
                             "path).")

    # the disk tier's storage-fault plane and integrity plane (the JAX
    # package's flags, names, defaults and help)
    parser.add_argument("--inject_io_fault", type=str, default="",
                        help="Debug: seeded storage-fault schedule "
                             "'eio=P,short=P,torn=P,stall=P,stall_ms=N,"
                             "seed=N,persist_after=N' injected at the "
                             "disk-tier row store's pread/pwrite seam — "
                             "transient EIO / short reads / torn writes "
                             "are retried (bit-invisible below the "
                             "budget), stalls exercise the watchdog, and "
                             "a row failing persist_after consecutive "
                             "attempts is quarantined (re-initialized "
                             "from its base row).")
    parser.add_argument("--io_retries", type=int, default=3,
                        help="Bounded retries per row-store I/O op "
                             "(exponential backoff + jitter) before the "
                             "ladder degrades to row quarantine.")
    parser.add_argument("--io_backoff_ms", type=float, default=5.0,
                        help="Base backoff between row-store I/O retries "
                             "(doubles per attempt, jittered).")
    parser.add_argument("--io_deadline_ms", type=float, default=30000.0,
                        help="Per-op watchdog deadline for row-store I/O: "
                             "a pread/pwrite in flight longer than this "
                             "declares the store unusable with one "
                             "actionable timeout error instead of "
                             "wedging the worker silently (0 disables "
                             "the watchdog).")
    parser.add_argument("--io_queue_bound", type=int, default=0,
                        help="Row-store work-queue bound (ops): a slow "
                             "disk applies backpressure to the dispatch "
                             "path instead of accumulating unbounded "
                             "pending scatter deltas in host RAM. 0 = "
                             "auto (max(8, 4 x --round_window)).")
    parser.add_argument("--io_checksums", action="store_true",
                        dest="io_checksums", default=True,
                        help="Per-row CRC32 verification of the disk-"
                             "tier row store: every row read checks a "
                             "write-time sidecar checksum; mismatches "
                             "repair from the CRC'd .rows snapshot or "
                             "quarantine (the default for the disk "
                             "tier).")
    parser.add_argument("--no_io_checksums", action="store_false",
                        dest="io_checksums",
                        help="Disable per-row checksums (bit-identical "
                             "trajectories on the clean path either "
                             "way; COMMEFFICIENT_IO_CHECKSUMS=0 is the "
                             "no-restart kill-switch).")
    parser.add_argument("--io_scrub_rows", type=int, default=0,
                        help="Background scrub budget: verify this many "
                             "cold rows per round against the checksum "
                             "sidecar on the store's ordered I/O worker "
                             "(rolling cursor over the population), so "
                             "corruption in rows no cohort touches is "
                             "found and repaired before the next "
                             "snapshot inherits it (0 = off; requires "
                             "--io_checksums).")

    # accepted and ignored, as the JAX package ignores them
    parser.add_argument("--port", type=int, default=5315,
                        help="Accepted for compatibility; unused.")
    parser.add_argument("--share_ps_gpu", action="store_true",
                        help="Accepted for compatibility; unused.")
    parser.add_argument("--nan_threshold", type=float, default=999,
                        help="Accepted for compatibility; unused.")
    parser.add_argument("--num_results_train", type=int, default=2,
                        help="Accepted for compatibility; unused.")
    parser.add_argument("--num_results_val", type=int, default=2,
                        help="Accepted for compatibility; unused.")
    parser.add_argument("--rng_impl",
                        choices=["threefry2x32", "rbg", "unsafe_rbg"],
                        default="threefry2x32",
                        help="The JAX package's PRNG choice: threefry2x32 "
                             "is accepted as a no-op; rbg and unsafe_rbg "
                             "name JAX PRNGs and are refused.")

    # observability (the JAX package's flags, names, defaults and help)
    parser.add_argument("--tensorboard", dest="use_tensorboard",
                        action="store_true",
                        help="Per-epoch scalars to a TensorBoard writer in "
                             "the run dir (console only when "
                             "torch.utils.tensorboard is missing).")
    parser.add_argument("--profile", action="store_true", dest="do_profile",
                        help="torch.profiler trace of --profile_steps "
                             "rounds of each epoch, from loop index 2.")
    parser.add_argument("--profile_dir", type=str, default="profiles")
    parser.add_argument("--profile_steps", type=int, default=3)
    parser.add_argument("--telemetry", action="store_true", dest="telemetry",
                        default=True,
                        help="Per-round on-device metrics + JSONL run "
                             "event log (the default).")
    parser.add_argument("--no_telemetry", action="store_false",
                        dest="telemetry",
                        help="Disable the telemetry plane (bit-identical "
                             "trajectories either way).")
    parser.add_argument("--telemetry_hist", action="store_true",
                        dest="telemetry_hist", default=True,
                        help="Append the schema-v3 log-magnitude "
                             "histogram block (emitted update + error "
                             "carry) to the on-device round metrics "
                             "(the default with telemetry on).")
    parser.add_argument("--no_telemetry_hist", action="store_false",
                        dest="telemetry_hist",
                        help="Drop the histogram block (12-field v2 "
                             "metric schema; bit-identical trajectories "
                             "either way).")
    parser.add_argument("--watch", action="store_true", dest="watch",
                        default=True,
                        help="Evaluate watch rules over the drained "
                             "metric stream (the default with telemetry "
                             "on; alerts land as watch_alert events).")
    parser.add_argument("--no_watch", action="store_false", dest="watch",
                        help="Disable the watch/alert plane.")
    parser.add_argument("--watch_rules", type=str, default="",
                        help="Watch rules 'METRIC{>|<}BOUND[@N]"
                             "[->log|trace[:R]|checkpoint]' joined by "
                             "','; BOUND a float or ewma*F (drift vs the "
                             "metric's own EWMA). Empty = the default "
                             "rule set.")
    parser.add_argument("--trace_rounds", type=str, default="",
                        help="Windowed round-aligned profiler capture(s) "
                             "'START:COUNT[,START:COUNT...]' over global "
                             "round_no; traces land in the run dir named "
                             "by the start round.")

    # health guards and fault injection (the JAX package's flags)
    parser.add_argument("--guards", action="store_true", dest="guards",
                        help="Enable per-round on-device health guards: "
                             "non-finite (or over-magnitude) rounds are "
                             "quarantined without touching (velocity, "
                             "error) and training continues.")
    parser.add_argument("--guard_max_abs", type=float, default=0.0,
                        help="Magnitude guard: trip when any updated PS "
                             "weight exceeds this absolute value "
                             "(0 = finiteness-only).")
    parser.add_argument("--snapshot_every", type=int, default=64,
                        help="Refresh the device-resident last-good server "
                             "snapshot every N healthy drained rounds "
                             "(guards only; 0 disables rollback).")
    parser.add_argument("--max_guard_trips", type=int, default=3,
                        help="Consecutive guard trips before aborting with "
                             "a fatal error (guards only).")
    parser.add_argument("--inject_fault", type=str, default="",
                        help="Debug: 'ROUND:KIND[,ROUND:KIND...]' with KIND "
                             "in {nan,inf} — overwrite one element of that "
                             "round's aggregated transmit with the value "
                             "before the server phase.")

    for flag, kw, item in UNPORTED:
        parser.add_argument(flag, **kw, help=f"Not ported yet ({item}).")
    return parser


def reject_unported(args) -> None:
    """Raise ``NotImplementedError`` for any option this slice does not
    carry, naming its ROADMAP item, and ``ValueError`` for a JAX PRNG
    (``--rng_impl rbg|unsafe_rbg``). Attributes an ``args`` object lacks
    count as unset."""
    for flag, dest, default, item in _unported_defaults():
        if getattr(args, dest, default) != default:
            raise NotImplementedError(
                f"{flag} is not ported yet ({item})")
    rng_impl = getattr(args, "rng_impl", "threefry2x32")
    if rng_impl != "threefry2x32":
        raise ValueError(
            f"--rng_impl {rng_impl} names a JAX PRNG, which has no meaning "
            "in the port (its randomness comes from torch.Generator); "
            "leave it at threefry2x32")
    if int(getattr(args, "shard_devices", 1) or 1) > 1:
        raise NotImplementedError(
            f"--shard_devices {args.shard_devices} is not ported "
            f"({ITEM_MULTI_2D})")
    spec = (getattr(args, "collective_plan", None) or "").strip()
    if spec == "auto" or ":" in spec:
        raise NotImplementedError(
            f"--collective_plan {spec} is not ported ({ITEM_MULTI_2D})")


def check_observability(args) -> None:
    """The JAX package's checks of the telemetry, watch, trace and guard
    flags: malformed specs fail at parse time, not rounds into a run."""
    from commefficient_torch.profiling import parse_trace_rounds
    from commefficient_torch.telemetry import parse_watch_rules

    assert args.max_guard_trips >= 1, "--max_guard_trips must be >= 1"
    assert args.snapshot_every >= 0, "--snapshot_every must be >= 0"
    if args.watch_rules:
        rules = parse_watch_rules(args.watch_rules)
        if any(r.action == "checkpoint" for r in rules) \
                and args.train_dataloader_workers > 0:
            print("NOTE: a watch 'checkpoint' reaction needs "
                  "--train_dataloader_workers 0 for a resumable save "
                  "(same constraint as --checkpoint_every_rounds); the "
                  "reaction will be skipped with a message")
    if args.trace_rounds:
        parse_trace_rounds(args.trace_rounds)
    if args.inject_fault:
        parse_inject_fault(args.inject_fault)
        if not args.guards:
            print("NOTE: --inject_fault without --guards will poison the "
                  "run with nothing to catch it (intentional only for "
                  "demonstrating the failure mode)")


def check_collectives(args) -> None:
    """The JAX package's checks of the sharded server's flags
    (``commefficient_tpu/config.py``)."""
    from commefficient_torch.ops.collectives import parse_collective_plan

    if args.reduce_dtype == "int8":
        assert args.server_shard, (
            "--reduce_dtype int8 quantizes the transmit reduce of the "
            "sharded server plane; it requires --server_shard")
    plan_spec = (getattr(args, "collective_plan", "") or "").strip()
    if plan_spec:
        assert args.reduce_dtype == "float32", (
            "--collective_plan and --reduce_dtype int8 both name wire "
            "dtypes; use --collective_plan alone (the int8 alias equals "
            "--collective_plan int8)")
        # fail at parse time, not rounds into a run
        plan = parse_collective_plan(plan_spec)
        if plan.quantized:
            assert args.server_shard, (
                "quantized --collective_plan legs require "
                "--server_shard (the block-scaled collectives live on "
                "the sharded server plane)")
    assert args.shard_devices >= 1, "--shard_devices must be >= 1"
    if args.server_shard:
        assert not args.do_topk_down, (
            "--server_shard is incompatible with --topk_down (stale-"
            "weight reconstruction lives on dense per-client rows)")


def check_participation(args) -> None:
    """The JAX package's checks of the participation and churn flags:
    ranges, and the participation, fault and churn specs parsed here, not
    rounds into a run."""
    from commefficient_torch.federated.participation import (
        parse_client_fault,
        parse_participation,
    )

    assert 0.0 <= args.client_dropout < 1.0, (
        f"--client_dropout {args.client_dropout} must be in [0, 1)")
    assert 0.0 < args.staleness_decay <= 1.0, (
        f"--staleness_decay {args.staleness_decay} must be in (0, 1]")
    assert args.client_retry_limit >= 0, (
        "--client_retry_limit must be >= 0")
    assert args.async_buffer >= 0, (
        f"--async_buffer {args.async_buffer} must be >= 0 (0 = "
        f"synchronous rounds)")
    if args.async_buffer:
        print(f"async buffered federation: fold every "
              f"{args.async_buffer} landed contribution(s), "
              f"w(Δ)={args.staleness_decay:g}**Δ exact-version staleness; "
              f"buffered dispatches fold the TRANSMIT only — client "
              f"carries advance on fold dispatches")
    if args.participation:
        parse_participation(args.participation, args.num_workers)
    fault_spec = (args.inject_client_fault or "").strip()
    if fault_spec:
        sched = parse_client_fault(fault_spec)
        assert args.train_dataloader_workers == 0, (
            "--inject_client_fault needs --train_dataloader_workers 0: "
            "dropped clients requeue into the live sampler epoch, and a "
            "prefetch thread would have drawn rounds past the requeue "
            "point (same constraint as --checkpoint_every_rounds)")
        if sched.slow and (args.local_momentum > 0
                           or args.error_type == "local"
                           or args.do_topk_down):
            print("NOTE: straggler late landings fold the TRANSMIT only — "
                  "per-client velocity/error/stale-weight state does not "
                  "advance for a straggler cohort")
    churn_spec = (getattr(args, "churn", "") or "").strip()
    if churn_spec:
        from commefficient_torch.federated.participation import parse_churn

        parse_churn(churn_spec)
        assert args.train_dataloader_workers == 0, (
            "--churn needs --train_dataloader_workers 0: the sampler "
            "steps the churn clock in-order on the main thread, and a "
            "prefetch thread would have drawn rounds past the churn "
            "point (same constraint as --inject_client_fault)")


def check_host_state(args) -> None:
    """The JAX package's checks of the storage-fault flags: a malformed
    ``--inject_io_fault`` or a nonsensical ladder fails here, not rounds
    into a run."""
    io_spec = (getattr(args, "inject_io_fault", "") or "").strip()
    if io_spec:
        from commefficient_torch.federated.host_state import parse_io_fault

        parse_io_fault(io_spec)
    assert args.io_retries >= 0, "--io_retries must be >= 0"
    assert args.io_backoff_ms >= 0, "--io_backoff_ms must be >= 0"
    assert args.io_deadline_ms >= 0, "--io_deadline_ms must be >= 0"
    assert args.io_queue_bound >= 0, "--io_queue_bound must be >= 0"
    assert args.io_scrub_rows >= 0, "--io_scrub_rows must be >= 0"
    if args.io_scrub_rows and not args.io_checksums:
        print("NOTE: --io_scrub_rows verifies rows against the per-row "
              "checksum sidecar; with --no_io_checksums there is nothing "
              "to verify and the scrub is inert")


def parse_args(default_lr=None, argv=None):
    args = build_parser(default_lr).parse_args(argv)
    reject_unported(args)
    check_collectives(args)
    check_observability(args)
    check_participation(args)
    check_host_state(args)
    if args.mode == "fedavg":
        assert args.local_batch_size == -1, "fedavg requires local_batch_size == -1"
        assert args.local_momentum == 0, "fedavg requires local_momentum == 0"
        assert args.error_type == "none", "fedavg requires error_type == none"
    if args.stream_sketch:
        # the round composes outside the fused sketch window; say so for
        # the configs that are plainly outside it
        if args.mode != "sketch":
            print(f"NOTE: --stream_sketch is sketch-mode only; mode="
                  f"{args.mode} runs the composed path")
        elif (args.local_momentum > 0 or args.error_type == "local"
              or args.do_dp or args.max_grad_norm is not None
              or args.do_topk_down):
            print("NOTE: --stream_sketch needs the fused client phase "
                  "(no per-client sketch-space state — set "
                  "--local_momentum 0 / --error_type virtual — and no "
                  "clip, DP, or topk-down); this config runs the "
                  "composed path")
    if args.sketch_coalesce and not args.stream_sketch:
        # the coalescer refines the leaf-streamed accumulate; without
        # --stream_sketch there are no per-leaf launches to coalesce
        print("NOTE: --sketch_coalesce refines the streaming client "
              "phase; without --stream_sketch it has nothing to coalesce "
              "and this config runs the composed path")
    return args
