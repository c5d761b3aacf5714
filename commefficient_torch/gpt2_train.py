"""GPT-2 PersonaChat federated training entry point of the port (BASELINE.md
config 5).

    python -m commefficient_torch.gpt2_train --dataset_dir ./dataset \
        --mode sketch --error_type virtual --local_momentum 0 \
        --virtual_momentum 0.9 --num_workers 4 --local_batch_size 2 \
        --num_candidates 2 --max_seq_len 256 --num_epochs 1

Loop parity with ``gpt2_train.py`` of the JAX package: the special-token
surgery (``<bos>``, ``<eos>``, ``<pad>``, ``<speaker1>``, ``<speaker2>``)
with the model's vocabulary sized to the tokenizer, ``PiecewiseLinear``
from ``--lr_scale`` down to 0 over the run, the round engine
(``federated/engine.py``), one ``TableLogger`` row a round, download and
upload counted in epoch 1 only, ``--checkpoint_every``,
``--checkpoint_every_rounds`` and ``--resume`` (``federated/checkpoint.py``),
and at the end ``save_pretrained`` (``<log_dir>/model.npz``, which the JAX
package's ``load_checkpoint`` reads) and the val NLL, multiple-choice
accuracy and perplexity. ``--eval_before_start`` runs the val pass before
the first round.

The model is the full GPT-2-small double-heads geometry (vocabulary
``max(50262, len(tokenizer))``, 1,024 positions), or, under ``--test`` or
``COMMEFFICIENT_TINY_MODEL``, n_embd 64, 2 layers (or
``COMMEFFICIENT_TINY_LAYERS``), 2 heads, vocabulary ``max(512,
len(tokenizer))``. It starts from the seeded initializers, then, in the
JAX package's order: HF weights from the local directory
``--model_checkpoint`` (``models/gpt2.load_hf_gpt2``: ``pytorch_model.bin``
or ``model.safetensors``) with the embedding grown to the model's
vocabulary (``resize_token_embeddings``), else a saved run dir's ``model.npz``
(``checkpoint.load_matching``, at least one tensor loaded). Nothing is
downloaded: without weight files the run keeps the seeded init.
``--finetune`` points the model load at ``--finetune_path`` (a saved run
dir), keeps the base tokenizer, and only evaluates. The tokenizer is the
port's byte-level BPE
(``data_utils/tokenization.py``) and the data the seeded synthetic
PersonaChat when no ``personachat_self_original.json`` is under
``--dataset_dir``. Runs on ``cuda`` unless ``--device cpu``; float32
(TF32 off), the forward and backward in bfloat16 under ``--bf16``.
Under ``torchrun --nproc_per_node N`` the round's slots split over the
ranks, as in ``cv_train``; rank 0 alone prints and writes. The
observability plane and the guards are ``cv_train``'s (the event log is
``<log_dir>/telemetry.jsonl``); as in the JAX package, ``gpt2_train``
writes no TensorBoard scalars.

Sequence parallelism: under ``torchrun`` with ``--seq_parallel
ring|ulysses --seq_devices Q`` the ranks form the grid with a ``seq`` axis
of ``Q`` (``parallel/mesh.py``); each seq rank holds ``max_seq_len / Q``
tokens of every sequence, attention runs exactly over the whole sequence
(``parallel/ring.py``, ``parallel/ulysses.py``) and the collate emits the
shifted labels the seq-parallel loss reads. The REALIZED grid decides it:
a world too small for a seq axis prints ``--seq_parallel ... disabled``
and trains the dense model, as the JAX package does.

    torchrun --standalone --nproc_per_node 2 -m commefficient_torch.gpt2_train \
        --seq_parallel ring --seq_devices 2 --num_devices 1 ...

Tensor parallelism and mixture of experts: ``--model_devices M`` gives
the grid a ``model`` axis (each rank computes ``n_head / M`` heads and
``4 n_embd / M`` MLP columns, ``models/gpt2.TPDense``; composes with
``--seq_parallel ring``), ``--n_experts E`` makes every other block an MoE
block (``--moe_dispatch``, ``--moe_capacity_factor``, ``--moe_aux_coef``)
and ``--expert_devices`` splits its experts over an ``expert`` axis
(``parallel/moe.py``). The REALIZED grid decides them, with the JAX
package's checks (``n_head`` and ``4 n_embd`` divisible by the realized
model axis, ``n_experts`` by the realized expert axis) and its
``--expert_devices ... disabled`` message.

    torchrun --standalone --nproc_per_node 4 -m commefficient_torch.gpt2_train \
        --num_devices 1 --model_devices 2 --n_experts 4 --expert_devices 2 ...

The pipeline: ``--pipeline_devices S`` gives the grid a ``stage`` axis;
each stage rank runs its contiguous range of the blocks on the GPipe
clock over ``--pp_microbatches`` microbatches of a client batch
(``parallel/pipeline.make_gpt2_pp_losses``; stage 0 embeds, the last
stage runs the heads), and the round sums the stages' gradients. The
REALIZED grid decides it (a world too small drops it with the grid's
``--pipeline_devices ... reduced`` warning), with the JAX package's check
``n_layer >= S``. It composes with the seq, model and expert axes.

    torchrun --standalone --nproc_per_node 2 -m commefficient_torch.gpt2_train \
        --num_devices 1 --pipeline_devices 2 --pp_microbatches 2 ...
"""

from __future__ import annotations

import math
import os
import random

import numpy as np
import torch

from commefficient_torch.config import parse_args
from commefficient_torch.convert import flax_from_port, params_from_flax
from commefficient_torch.data_utils import (
    FedLoader,
    FedPERSONA,
    make_personachat_collate_fn,
)
from commefficient_torch.data_utils.tokenization import (
    ATTR_TO_SPECIAL_TOKEN,
    get_tokenizer,
)
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
    save_round_state,
)
from commefficient_torch.federated.engine import (
    PipelinedRoundEngine,
    cohort_lookahead,
)
from commefficient_torch.federated.losses import make_gpt2_losses
from commefficient_torch.federated.participation import (
    attach_churn,
    attach_participation,
    audit_churn,
    expire_participation,
)
from commefficient_torch.models.gpt2 import (
    GPT2DoubleHeads,
    load_hf_gpt2,
    resize_token_embeddings,
)
from commefficient_torch.ops.flat import ParamLayout
from commefficient_torch.parallel import (
    destroy_distributed,
    grid_sizes,
    main_first,
    quiet_unless_main,
    requested_axes,
    start_client_group,
)
from commefficient_torch.parallel.pipeline import make_gpt2_pp_losses
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

# the model's vocabulary at full width: GPT-2's 50,257 and 5 special tokens
FULL_VOCAB = 50257 + 5


def get_data_loaders(args, tokenizer, emit_shifted: bool = False):
    train_dataset = FedPERSONA(
        tokenizer, args.num_candidates, args.max_history,
        args.personality_permutations,
        args.dataset_dir, args.dataset_name, None, args.do_iid,
        args.num_clients, train=True, download=True,
        max_seq_len=args.max_seq_len)
    val_dataset = FedPERSONA(
        tokenizer, -1, args.max_history, 1,
        args.dataset_dir, args.dataset_name, None, train=False,
        download=False, max_seq_len=args.max_seq_len)
    # val candidates vary; the collate pads to at least 3 for one shape
    n_cand_val = max(args.num_candidates, 3)
    train_loader = FedLoader(
        train_dataset, args.num_workers, args.local_batch_size,
        collate_fn=make_personachat_collate_fn(args.max_seq_len,
                                               args.num_candidates,
                                               emit_shifted=emit_shifted))
    val_loader = FedLoader(
        val_dataset,
        val_batch_size=args.valid_batch_size * args.num_workers,
        collate_fn=make_personachat_collate_fn(args.max_seq_len,
                                               n_cand_val,
                                               emit_shifted=emit_shifted))
    return train_loader, val_loader


def grid_planes(args, group):
    """``(seq, model, stage, expert)``: the groups the REALIZED grid has
    for ``--seq_parallel``, ``--model_devices``, ``--pipeline_devices``
    and ``--expert_devices`` (None where it has no such axis). A request
    the grid could not meet (one process, or a world too small) is
    dropped as the JAX package's ``gpt2_train`` drops it: ``--seq_parallel
    ... disabled`` and ``--expert_devices ... disabled`` with the grid's
    shape, and the flag set back to its default (a model or stage axis
    the grid lacks is dropped without a message, as there)."""
    inner = requested_axes(args)
    wants = {"seq": args.seq_parallel != "none",
             "model": inner["model_devices"] > 1,
             "stage": inner["pipeline_devices"] > 1,
             "expert": inner["expert_devices"] > 1}
    if not any(wants.values()):
        return None, None, None, None
    if group is None:
        # one process: the grid policy over one device (its warnings)
        sizes = grid_sizes(args.num_workers, args.num_devices,
                           args.shard_devices, 1, **inner)
        shape = {a: n for a, n in sizes.items()
                 if a == "clients" or n > 1}
    else:
        shape = {a["name"]: a["size"] for a in group.topology()["axes"]}
    seq, model, stage, expert = (
        (group.seq, group.model, group.stage, group.expert)
        if group is not None else (None,) * 4)
    if wants["seq"] and seq is None:
        print(f"--seq_parallel {args.seq_parallel} disabled: "
              f"mesh has no seq axis ({shape})")
        args.seq_parallel = "none"
    if args.expert_devices > 1 and expert is None:
        print(f"--expert_devices {args.expert_devices} disabled: "
              f"mesh has no expert axis ({shape})")
        args.expert_devices = 1
    return (seq if args.seq_parallel != "none" else None,
            model if wants["model"] else None,
            stage if wants["stage"] else None, expert)


def build_model(args, len_tokenizer: int, seq_group=None, model_group=None,
                expert_group=None) -> GPT2DoubleHeads:
    """The run's model; with ``seq_group`` its attention is
    ``--seq_parallel``'s over that group, with ``model_group`` its heads
    and MLP columns are sliced over that group, with ``--n_experts`` every
    other block is an MoE block, its experts over ``expert_group``."""
    geometry = (dict(attn_impl=args.seq_parallel, seq_group=seq_group)
                if seq_group is not None else {})
    if model_group is not None:
        geometry["model_group"] = model_group
    if args.n_experts:
        geometry.update(n_experts=args.n_experts,
                        moe_dispatch=args.moe_dispatch,
                        moe_capacity_factor=args.moe_capacity_factor,
                        expert_group=expert_group)
    if args.do_test or os.environ.get("COMMEFFICIENT_TINY_MODEL"):
        dims = dict(vocab_size=max(512, len_tokenizer),
                    n_positions=args.max_seq_len, n_embd=64,
                    n_layer=int(os.environ.get("COMMEFFICIENT_TINY_LAYERS",
                                               2)), n_head=2)
    else:
        dims = dict(vocab_size=max(FULL_VOCAB, len_tokenizer),
                    n_positions=1024, n_embd=768, n_head=12)
    if seq_group is not None and args.seq_parallel == "ulysses":
        assert dims["n_head"] % args.seq_devices == 0, \
            "ulysses needs n_head divisible by --seq_devices"
    if model_group is not None:
        nm = model_group.size  # realized size, possibly reduced
        assert dims["n_head"] % nm == 0, \
            f"--model_devices (realized {nm}) must divide n_head"
        assert (4 * dims["n_embd"]) % nm == 0, \
            f"--model_devices (realized {nm}) must divide the MLP hidden dim"
    if expert_group is not None:
        ne = expert_group.size  # realized size, possibly reduced
        assert args.n_experts % ne == 0, \
            f"--expert_devices (realized {ne}) must divide --n_experts"
    return GPT2DoubleHeads(**dims, **geometry)


def initial_weights(args, model: GPT2DoubleHeads, len_tokenizer: int):
    """The run's starting flat weights, in the JAX package's order: the
    seeded init; over it HF weights from ``args.model_checkpoint``, else a
    saved run dir's ``model.npz`` (every leaf whose path and shape match;
    at least one must). Returns ``(flat weights, what was loaded)``.

    The HF embedding grows to the model's vocabulary, ``max(50,262,
    len(tokenizer))`` (``build_model``). The JAX package grows it to
    ``len(tokenizer)``, the same size with GPT-2's own tokenizer; with a
    smaller one (the vendored vocabulary without a checkpoint's
    ``vocab.json``) its table and model disagree and it cannot start."""
    layout = ParamLayout(model)
    init_model_(model, args.seed)
    template = flax_from_port(dict(model.named_parameters()), layout)
    tree, what = template, "seeded init"
    pretrained = load_hf_gpt2(template, args.model_checkpoint)
    npz = os.path.join(args.model_checkpoint, "model.npz")
    if pretrained is not None:
        tree = resize_token_embeddings(
            pretrained, max(len_tokenizer, model.vocab_size))
        what = "local pretrained GPT-2 weights"
    elif os.path.exists(npz):
        ckpt_params, _ = load_checkpoint(npz[:-len(".npz")])
        tree, loaded, skipped = load_matching(template, ckpt_params)
        assert loaded > 0, (
            f"--finetune checkpoint {args.model_checkpoint} shares no "
            f"tensor shapes with the current model geometry "
            f"(COMMEFFICIENT_TINY_MODEL / --max_seq_len mismatch?); "
            f"refusing to silently train from scratch")
        what = f"saved run dir: {loaded} tensors, fresh: {len(skipped)}"
    return layout.flatten(params_from_flax(tree, layout)), what


def run_batches(model, opt, lr_scheduler, loader, args, timer, training,
                epoch=0, epoch_fraction=1, logger=None, resume_mid=None,
                totals=(0.0, 0.0)):
    model.train(training)
    if not training:
        nlls, accs = [], []
        spe = len(loader)
        for batch_idx, batch in enumerate(loader):
            if batch_idx > 5 and args.do_test and batch_idx < spe - 5:
                continue
            nll, acc = model(batch)
            nlls.append(float(np.mean(nll)))
            accs.append(float(np.mean(acc)))
        return np.mean(nlls), np.mean(accs), np.exp(np.mean(nlls))

    spe = loader.steps_per_epoch()
    num_clients = loader.dataset.num_clients
    client_download = np.zeros(num_clients)
    client_upload = np.zeros(num_clients)
    losses = []
    i0, ex = restore_mid_epoch(resume_mid, loader, client_download,
                               client_upload)
    losses.extend(np.asarray(ex.get("losses", [])).tolist())
    save_every = int(args.checkpoint_every_rounds or 0)
    # rounds are dispatched without a host wait and their metrics fetched
    # every --metrics_drain_every rounds; a row's train_time is its drain
    # interval divided over the rounds it fetched
    engine = PipelinedRoundEngine(model, opt, lr_scheduler,
                                  window=args.round_window,
                                  drain_every=args.metrics_drain_every)
    prof = StepProfiler(args.profile_dir, num_steps=args.profile_steps,
                        enabled=args.do_profile and model.is_main)
    # the watch plane's checkpoint reaction, serviced at a round boundary
    rt = getattr(model, "telemetry", None)
    watch_armed = watch_can_checkpoint(args)
    meta_by_round = {}

    def consume(results):
        nonlocal client_download, client_upload
        if not results:
            return
        interval = timer()
        for res in results:
            loss, download, upload = res.values
            client_download += download
            client_upload += upload
            loss = float(np.mean(loss))
            losses.append(loss)
            row_batch_idx, row_lr = meta_by_round.pop(res.index)
            if logger is not None:
                logger.append({
                    "batch_idx": row_batch_idx, "lr": row_lr,
                    "train_time": interval / len(results),
                    "train_loss": loss,
                    "total_time": timer.total_time,
                    "down (MiB)": round(download.sum() / (1024 * 1024)),
                    "up (MiB)": round(upload.sum() / (1024 * 1024)),
                })

    try:
        for batch_idx, batch in enumerate(cohort_lookahead(loader, model)):
            if batch_idx > 2 and args.do_test and batch_idx < spe - 10:
                continue
            if i0 + batch_idx > spe * epoch_fraction:
                break
            prof.step(batch_idx)
            done = engine.submit(batch)
            # the scheduler stepped inside submit(): this round's row logs
            # the batch index and the learning rate it ran with
            meta_by_round[engine.rounds_submitted - 1] = (
                i0 + batch_idx + 1, lr_scheduler.get_last_lr()[0])
            consume(done)
            do_save = bool(save_every
                           and (i0 + batch_idx + 1) % save_every == 0)
            forced = False
            if take_watch_checkpoint(model, watch_armed, bool(done)):
                if args.train_dataloader_workers == 0:
                    do_save = forced = True
                else:
                    print("watch: checkpoint reaction skipped (needs "
                          "--train_dataloader_workers 0 for a "
                          "resumable save)")
            if do_save:
                # drain first: the saved sampler position must describe
                # exactly the rounds folded into the run state
                consume(engine.drain())
                save_round_state(
                    args, epoch, i0 + batch_idx + 1,
                    loader.sampler.get_state(), model, opt, lr_scheduler,
                    totals,
                    extras={"download": client_download,
                            "upload": client_upload,
                            "losses": np.asarray(losses, np.float64)})
                if rt is not None:
                    rt.event("checkpoint", epoch=epoch,
                             round=model.rounds_dispatched - 1,
                             round_in_epoch=i0 + batch_idx + 1,
                             **({"forced_by_watch": True} if forced
                                else {}))
        consume(engine.drain())
    finally:
        prof.close()
    if not losses and getattr(model, "_population", None) is not None:
        # --churn's open-world end: the live population emptied before this
        # epoch drew a cohort and no joiner can refill it
        return None, client_download, client_upload
    return np.mean(losses), client_download, client_upload


def test_gpt2(model, val_loader, args, logger=None, timer=None):
    timer = timer or Timer()
    nll, acc, ppl = run_batches(model, None, None, val_loader, args, timer,
                                training=False)
    stats = {"val_nll": nll, "val_acc": acc, "val_ppl": ppl,
             "val_time": timer(), "total_time": timer.total_time}
    (logger or TableLogger()).append(stats)
    return stats


def train_gpt2(model, opt, scheduler, train_loader, val_loader, args,
               log_dir, logger=None, timer=None, start_epoch=0,
               totals=(0.0, 0.0), resume_mid=None):
    timer = timer or Timer()
    total_download, total_upload = totals
    for epoch in range(start_epoch, math.ceil(args.num_epochs)):
        if epoch == math.ceil(args.num_epochs) - 1:
            epoch_fraction = args.num_epochs - epoch
        else:
            epoch_fraction = 1
        train_loss, download, upload = run_batches(
            model, opt, scheduler, train_loader, args, timer, training=True,
            epoch=epoch, epoch_fraction=epoch_fraction, logger=logger,
            resume_mid=(resume_mid if epoch == start_epoch else None),
            totals=(total_download, total_upload))
        if train_loss is None:
            print("ending training: live population is empty with no "
                  "pending joiners (--churn open-world end state)")
            break
        if epoch == 0:
            # download tracking is valid in epoch 1 only (the reference's)
            total_download += download.sum() / (1024 * 1024)
            total_upload += upload.sum() / (1024 * 1024)
        maybe_save_run_state(args, epoch, model, opt, scheduler,
                             (total_download, total_upload))
    print(f"Total Download (MiB): {total_download:0.2f} (only epoch 1)")
    print(f"Total Upload (MiB): {total_upload:0.2f} (only epoch 1)")
    n = train_loader.dataset.num_clients
    print(f"Avg Download Per Client: {total_download / n:0.2f} "
          f"(only epoch 1)")
    print(f"Avg Upload Per Client: {total_upload / n:0.2f} (only epoch 1)")
    model.save_pretrained(log_dir)
    return test_gpt2(model, val_loader, args, timer=timer)


def train(argv=None, init_method=None, backend=None):
    """``init_method``: the process group's rendezvous under ``torchrun``
    (default ``env://``); ``backend``: the process group's backend when
    the caller names one (default: NCCL on the card, gloo on the CPU)."""
    args = parse_args(default_lr=4e-2, argv=argv)
    group = start_client_group(args, init_method, backend=backend)
    try:
        if group is not None and not group.active:
            print(f"rank {group.rank} idle: the client group has "
                  f"{group.size} ranks")
            return None
        return _train(args, group)
    finally:
        if group is not None:
            destroy_distributed()


def _train(args, group):
    quiet_unless_main()
    device = resolve_device(group.device if group is not None
                            else args.device)
    set_fp32_numerics()
    if not args.dataset_name:
        args.dataset_name = "PERSONA"
    print(args)
    sync = torch.cuda.synchronize if device.type == "cuda" else None
    timer = Timer(synch=sync)
    np.random.seed(args.seed)
    random.seed(args.seed)

    tokenizer = get_tokenizer(args.model_checkpoint)
    print(f"tokenizer: {type(tokenizer).__name__} (vocab {len(tokenizer)})")
    tokenizer.add_special_tokens(ATTR_TO_SPECIAL_TOKEN)
    # --finetune loads the model from a saved run dir and keeps the base
    # tokenizer; the run then only evaluates
    if args.do_finetune and not args.do_test:
        args.model_checkpoint = args.finetune_path
    # sequence, tensor, pipeline and expert parallelism: the realized grid
    # decides
    seq_group, model_group, stage_group, expert_group = grid_planes(
        args, group)
    model = build_model(args, len(tokenizer), seq_group, model_group,
                        expert_group)
    compute_dtype = torch.bfloat16 if args.do_bf16 else None
    moe_aux_coef = args.moe_aux_coef if args.n_experts else 0.0
    if stage_group is not None:
        # the pipelined loss carries the GPipe schedule; the model stays
        # the dense one
        n_stages = stage_group.size  # realized size, possibly reduced
        assert model.n_layer >= n_stages, \
            f"--pipeline_devices (realized {n_stages}) must be <= n_layer"
        compute_loss_train, compute_loss_val = make_gpt2_pp_losses(
            model, stage_group, n_micro=args.pp_microbatches,
            lm_coef=args.lm_coef, mc_coef=args.mc_coef,
            compute_dtype=compute_dtype, moe_aux_coef=moe_aux_coef)
    else:
        compute_loss_train, compute_loss_val = make_gpt2_losses(
            model, args.lm_coef, args.mc_coef, compute_dtype=compute_dtype,
            seq_group=seq_group, moe_aux_coef=moe_aux_coef)

    log_dir = make_logdir(args)
    if group is None or group.is_main:
        os.makedirs(log_dir, exist_ok=True)
        tokenizer.save_pretrained(log_dir)
    train_loader, val_loader = main_first(
        lambda: get_data_loaders(args, tokenizer,
                                 emit_shifted=seq_group is not None))

    init_params, what = initial_weights(args, model, len(tokenizer))
    print(f"initial weights: {what}")
    fed_model = FedModel(model, compute_loss_train, args, compute_loss_val,
                         num_clients=train_loader.dataset.num_clients,
                         init_params=init_params, device=device,
                         group=group)
    opt = FedOptimizer(fed_model, args)
    spe = train_loader.steps_per_epoch()
    print("Steps per epoch", spe)
    lr_schedule = PiecewiseLinear([0, args.num_epochs * spe],
                                  [args.lr_scale, 0.0])
    scheduler = LambdaLR(opt, lr_lambda=lambda s: lr_schedule(s))
    if args.do_finetune:
        # the JAX package's eval-only finetune path
        return test_gpt2(fed_model, val_loader, args, logger=TableLogger(),
                         timer=timer)
    # the participation layer (--participation, --inject_client_fault,
    # --async_buffer): the sampler's cohorts, faults, late landing
    pc = attach_participation(args, fed_model,
                              sampler=getattr(train_loader, "sampler", None))
    # the open-world population (--churn)
    pm = attach_churn(args, fed_model,
                      sampler=getattr(train_loader, "sampler", None))
    # the telemetry plane (on by default): <log_dir>/telemetry.jsonl
    rt = attach_run_telemetry(args, fed_model, log_dir, "gpt2_train")
    start_epoch, totals, resume_mid = resume_run(args, fed_model, opt,
                                                 scheduler)
    if rt is not None and (start_epoch or resume_mid is not None):
        rt.event("resume", start_epoch=start_epoch,
                 mid_epoch=resume_mid is not None)
    try:
        if args.eval_before_start and start_epoch == 0 \
                and resume_mid is None:
            test_gpt2(fed_model, val_loader, args, timer=timer)
        stats = train_gpt2(fed_model, opt, scheduler, train_loader,
                           val_loader, args, log_dir, logger=TableLogger(),
                           timer=timer, start_epoch=start_epoch,
                           totals=totals, resume_mid=resume_mid)
    finally:
        expire_participation(pc, rt)
        audit_churn(pm, rt)
        close_run_telemetry(fed_model, rt)
        fed_model.finalize()
    return stats


if __name__ == "__main__":
    train()
