#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and hold its CUDA kernels
against their plain PyTorch versions.

    python3 chip_smoke.py [--kernel-times [NAME ...]]

Phases (any failure exits non-zero; nothing is caught):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the kernels from ``commefficient_torch/csrc`` (one ``nvcc`` per
   source, all at once) and print ptxas's register / shared-memory / spill
   summary;
3. each of the six kernels against its plain version at the headline
   geometry (d = 6,568,640, 5 x 500,000 sketch) and at ragged ones (c not
   a multiple of 128, a partial last chunk, even r, t0 != 0, a row length
   not a multiple of the accumulate's 1,024-cell tile, NaN, inf and
   subnormal cells, ties at the top-k threshold): exact equality, then
   CUDA-event times (median of 30, the plain versions' of 10, L2 flushed
   before each launch by a
   read of 96 MB, ``time_ms``) beside the bound the card's memory rate or
   issue rates set (the sign hashes' int32 operations count for the four
   sketch kernels, ``HASH_ALU_OPS`` and ``QUERY_ALU_OPS_*``), and the time
   of one PyTorch call
   computing the same function where there is one (``torch.topk`` for the
   descent, with ``torch.kthvalue`` beside it). Also exact: the running
   accumulate's segment form, which reads a group's flat vector in place,
   against its padded plain version at a segment straddling a chunk
   boundary and at one ending at d; the count pass at unsorted, repeated,
   zero, negative and all-``0x7FFFFFFF`` thresholds, on views at a 4-byte
   offset (``bits[1:]``), of 1, 3 and 129 patterns, on NaN, inf and
   subnormal patterns, and twice back to back; the histogram radix select
   descent at a view not 16-byte aligned (``bits[1:]``), at k = n and
   k > n, and on all-equal and all-zero patterns; the fused epilogue at
   p = 0 (all kept) and p = 0x7F800001 (only NaNs kept), its update equal
   to the masked estimates bit for bit, NaN payloads included; the query
   masked at d as the round calls it (its tail +0.0 bit for bit, the rest
   equal to ``mask_tail`` of the plain version), also on a table half of
   whose cells are zero;
4. the headline FetchSGD round at full width through FedModel /
   FedOptimizer / LambdaLR on a seeded synthetic batch (8 clients x 8
   images): 2 warm-up and 20 timed rounds, rounds/sec, a finite loss,
   and exactly 2 / 1 / 8 launches per round of the accumulate, the query
   and the count pass, no call of ``ChunkLayout.mask_tail`` (the query
   kernel writes the padded tail), the device time of each port kernel,
   the device memsets and device operations per round
   (``torch.profiler``); then the server phase
   from one table and state through the kernels and through the plain
   versions, which must be equal, and once more at top-k threshold 0
   (fewer than k nonzero estimates) on weights a quarter of which are
   -0.0: the new weights equal under == and different at most in the sign
   bit of zero weights, whose count is printed;
5. the opt-in round: the same round with ``--stream_sketch
   --sketch_coalesce --fused_epilogue`` and
   ``COMMEFFICIENT_PALLAS_TOPK_FUSED=1``, timed the same way, with the
   launches per round derived from the port's coalescing plan (one
   running accumulate per group and microbatch plus one for weight decay,
   one query, one descent, one epilogue, no zero-table accumulate and no
   count pass); the client table and the server phase through the kernels
   and through the plain versions, and the fused epilogue against the
   composed pair, all exactly equal;
6. ``commefficient_torch.cv_train.main`` for one short epoch and an eval
   on synthetic CIFAR10 in a temporary directory, once as the headline
   round and once with the opt-in flags;
7. the other modes at full width, 16 clients, seeded synthetic batches of
   8 images a client: ``c1`` (uncompressed, 1 worker), ``c2`` (true top-k,
   8 workers, k = 50,000; with the per-pass descent and once more with
   ``COMMEFFICIENT_PALLAS_TOPK_FUSED=1``), ``local-topk`` (local error and
   momentum), ``sketch-local`` (local error and momentum in sketch space,
   5 x 500,000) and ``fedavg`` (1 local epoch in chunks of 4): 2 warm-up
   and 6 timed rounds each, rounds/sec beside the card's line, a finite
   loss, the launches per round derived from the code's structure
   (``modes_per_round``; 0 for the kernels a path does not run), the
   device's busy share and time by kernel over 3 profiled rounds, and one
   server step from the same round context through the kernels and
   through the plain versions, whose weights, server state and scattered
   client rows must be equal; and the count pass once on the flat,
   unpadded 6,568,640-pattern vector that ``true_topk`` hands it.
8. the run lifecycle at full width (``phase_lifecycle``; cuDNN pinned
   deterministic, ``torch.backends.cudnn.deterministic = True`` and
   ``benchmark = False``, where bits are compared): the headline and the
   opt-in round through ``PipelinedRoundEngine(window=2,
   drain_every=8)`` for 16 rounds, bit-equal to the synchronous loop
   from the same state, every non-drain submit under
   ``torch.cuda.set_sync_debug_mode("error")`` (any synchronizing call
   raises) with 0 counted fetches, 2 / 1 / 8 launches a headline round;
   rounds/sec and the device's busy share (``torch.profiler``) of the
   loop and the engine in 2 alternating pairs of 24 rounds, for both
   rounds, beside
   the card's line (data, no claim); resume: 6 rounds straight against 3
   rounds, ``save_round_state``, a new FedModel / FedOptimizer / LambdaLR
   restored by ``load_run_state`` and 3 more, weights, server state,
   client rows and the download accounting bit-equal (the headline round,
   and sketch-local with 16 clients' tables), with the save and load ms
   and the file's size; ``--batchnorm``: d = 6,573,120, 10 headline
   rounds with finite losses, 2 / 1 / 8 launches a round and finite
   averaged running statistics, and one server step equal through
   kernels and plain versions; ``cv_train --batchnorm`` with
   ``--checkpoint_every_rounds 2`` and then ``--resume auto`` from its
   round-2 run state: final weights and statistics bit-identical with
   cuDNN deterministic (with cuDNN free, the count of differing arrays
   is printed).
9. GPT-2 on PersonaChat at full width (``phase_gpt2``: BASELINE.md config
   5, d = 124,444,417, vocab 50,262, 12 x 768, 12 heads; bench.py's
   round of 4 clients x 2 examples x 2 candidates x 256 tokens, a
   5 x 500,000 sketch, 20 blocks, k = 50,000, virtual momentum 0.9, on
   seeded synthetic token batches): the six kernels against their plain
   versions at this geometry (Tn = 249 chunks; the count pass and the
   descent over 124,523,904 patterns), exact and timed; three legs
   through FedModel, the headline round in float32 and under ``--bf16``
   and the opt-in round in float32, each 2 warm-up and 6 timed rounds
   with tokens/sec and rounds/sec, the launches a round checked exactly
   (2 / 1 / 8, and the coalescing plan's count), the client / server
   split, the device's busy share and time by kernel over 3 profiled
   rounds and the peak memory, beside the card's line; one server step
   through kernels and plain versions; one ``gpt2_train`` epoch on the
   synthetic PersonaChat with a finite val NLL and perplexity.
10. the other CV models (``phase_cv_models``): the six kernels against
   their plain versions at FEMNIST ResNet101-LN's geometry (d =
   42,620,926, Tn = 86 chunks; the count pass and the descent over
   43,008,256 patterns, k = 50,000), exact and timed; the FEMNIST
   ResNet101-LN round at full width (8 clients x 16 images of 28 x 28, the
   5 x 500,000 sketch, k = 50,000, virtual momentum 0.9) on batches drawn
   through ``FedEMNIST``'s synthetic writers, the FEMNIST transforms and
   ``FedLoader``: the headline and the opt-in leg, each 2 warm-up and 20
   timed rounds with rounds/sec and images/sec, the launches a round
   checked exactly (2 / 1 / 8, and the coalescing plan's count), the
   client / server split, the busy share and time by kernel over 5
   profiled rounds, the peak memory, and a server step through kernels
   and plain versions; the loader's batches/sec plain and under
   ``PrefetchLoader``, and the native data plane against its numpy
   versions; the ImageNet FixupResNet50 round of scripts/imagenet.sh (7
   clients x 64 images at 224 x 224, uncompressed, Fixup's LR groups,
   microbatches of 16) on ``FedImageNet``'s synthetic tree through the
   fused transforms, timed, profiled, its three LR groups read back and
   one server step equal to ``ps - (g + 0.9 v) * lr_vec``; and
   ``python -m commefficient_torch.cv_train`` on EMNIST with
   ResNet101LN, and ``--finetune`` from a CIFAR100 ResNet9 checkpoint
   written in the same phase.
11. the multi-GPU data plane and HF GPT-2 weights (``phase_multi``): (1)
   each rank's query, count passes, partial re-sketch and fused epilogue
   of the sharded server at ``t0 = rank * ceil(T / n)`` for n = 2, 4, 8 at
   ResNet9's (T = 14) and GPT-2's (T = 249) full width, the padded tail
   included: each launch equal to its plain version, the ranks' estimates
   concatenated equal to the unsharded query, their counts summed equal
   to the unsharded counts, their partial tables summed with the
   unsharded table's ``== 0`` pattern and its values to float32 order,
   rank 1's launches timed; (2) a NCCL process group of one rank in this
   process: the headline round with ``--server_shard`` bit-equal to the
   single-device round (cuDNN deterministic), then 10 timed rounds each
   of the sharded fp32 round, the same with ``--fused_epilogue``,
   ``--collective_plan int8`` and
   ``uplink=int8,downlink=fp8_e4m3,table=int4`` with finite losses, 2 /
   1 / 8 launches a round per rank (1 / 1 / 8 / 1 with the epilogue), the engine's non-drain submits under
   ``set_sync_debug_mode("error")``, the quantized legs' error-feedback
   identity, rounds/sec beside phase 4's; (3) ``torchrun --nproc_per_node
   1 -m commefficient_torch.cv_train --server_shard --collective_plan
   int8`` on synthetic CIFAR10 in a subprocess: exit 0, finite losses;
   (4) two gloo ranks on ``cuda:0`` (gloo takes every collective the port
   uses on CUDA tensors; two NCCL ranks cannot share a card): the sharded
   and the replicated headline round bit-equal to each other and on both
   ranks, and within ``rtol=1e-4, atol=1e-6`` of the one-rank round with
   99% of its kept set; (5) a seeded GPT-2-small checkpoint written as
   ``model.safetensors`` and ``pytorch_model.bin``, both loaded bit-equal,
   the run's initial weights from it (the embedding grown to 50,262),
   10 timed rounds from them (tokens/sec and peak memory beside phase
   9's), ``gpt2_train`` for 2 rounds from the directory and
   ``--finetune`` on its run dir (a finite val NLL, the saved leaves
   loaded bit for bit).

12. the observability plane and the health guards
   (``phase_observability``): (1) the headline and the opt-in ResNet9
   round and GPT-2-small float32 with telemetry, histograms, watch and
   guards on, the launches of their rounds checked exactly (the planes
   launch no port kernel), and one server step each whose metric vector,
   computed on the card, equals ``device_round_metrics`` computed on the
   CPU from the fetched planes (counts, update_nnz, topk_threshold and
   guard_ok exact, norms within ``OBS_NORM_RTOL``), with the device ms
   and operations of the metric vector and of the guard per round
   (``torch.profiler``); (2) 10 headline rounds with telemetry and guards
   on bit-equal to the same rounds with both off (cuDNN deterministic);
   (3) 16 engine rounds with everything on, each non-drain submit under
   ``set_sync_debug_mode("error")`` with no fetch and each drain one
   fetch, every round in the event log with the full schema; (4)
   ``--inject_fault`` on the headline and the opt-in round (all six
   kernels): a NaN and an inf round each trip the verdict, leave weights,
   server state and client rows bit-equal to the state before, show the
   non-finite transmit with guard_ok 0, and give the same update, verdict
   and metrics through the kernels and the plain versions (NaN positions
   matched); a second consecutive trip restores the snapshot bit for bit
   and a third raises ``RuntimeError`` (``--max_guard_trips 3``); (5)
   ``python -m commefficient_torch.cv_train`` with the telemetry defaults
   and ``--guards --inject_fault 3:nan --trace_rounds 2:2``: its
   ``telemetry.jsonl`` read back with ``read_events`` holds the trip and
   ``trace_captured``, and ``trace_round_000002/trace.json`` exists; (6)
   rounds/sec with telemetry on against ``--no_telemetry`` and guards on
   against off, at the ResNet9 headline and GPT-2 f32, in 6 and 1
   alternating pairs of 20 engine rounds each, the ratios printed with
   their spread, and the host's side of telemetry on and off: the
   recorder's hooks' ms a round, and the operators' self time, operators
   and launches a round of one profiled window each
   (data: no exit code depends on them). Phases 1-11 run with
   ``--no_telemetry``, as before the plane existed.
13. client participation, stragglers and async buffering
   (``phase_participation``, ``--no_telemetry``): (1) the headline with
   the layer attached and nothing set (``--participation 1.0``), 10
   rounds bit-equal to the same rounds without it; (2) the headline with
   a 0.75 cohort (6 of 8 slots) under ``--inject_client_fault
   drop=0.1,slow=0.2,corrupt=0.05,delay=2,seed=7 --staleness_decay 0.5``
   for 20 engine rounds: the fault pattern equal to a CPU controller's,
   the launches of kernels 1, 3 and 5 as derived from it (a straggler
   round sketches twice), each non-drain submit under
   ``set_sync_debug_mode("error")`` with no fetch, every late landing's
   folded table against (S_now + w S_late) / (C_now + w C_late) computed
   in float64 from the held tensors (within 1e-6 of its largest
   magnitude), and one server step of a folded table through the kernels
   and the plain versions; (3) the opt-in round under the same faults,
   kernels 2, 3, 4 and 6 as derived; (4) ``--async_buffer 3``: launches
   as derived (a buffered dispatch launches no query and no count pass),
   a NaN-poisoned buffered contribution masked out of its fold and
   counted, a resume taken mid-buffer bit-equal to the continuous run;
   (5) GPT-2-small f32 with ``slow=0.25,delay=1``: launches as derived,
   tokens/sec and peak memory, the held sum the (5, 500,096) table; (6)
   rounds/sec (GPT-2: tokens/sec) with the layer on against off in
   alternating engine pairs, with their spread, and the device ms of one
   straggler dispatch (``torch.profiler``; data, not a gate).
14. per-client state off the card (``phase_offload``, sketch-local at
   ResNet9's full width, the 5 x 500,000 sketch, W = 8; state under a
   temporary directory): (1) 10 engine rounds at 64 clients in the
   ``hbm``, ``host`` and ``disk`` tiers (forced with the budget
   overrides), each with prefetch on and off, bit-equal in weights and
   every touched row, 10 / 1 / 8 launches a round of kernels 1 / 3 / 5 in
   each, every non-drain submit under ``set_sync_debug_mode("error")``
   with no fetch; 6 rounds of 0.75 cohorts under client faults on the
   disk tier bit-equal to the hbm tier; (2) the plan at the EMNIST
   population (3,500 clients, 65.21 GiB) from the planner's own probes
   with ``MemTotal``, then the host tier at 3,500 clients or, where the
   planner puts them on disk, at the largest multiple of 500 it places
   in host, against the hbm tier forced at the same population, in 1
   pair of 20 engine rounds (rounds/sec, device memory, the
   resident set); (3) 10^5 clients on the disk tier the planner picks
   (2.0 TB logical): 8 timed rounds (prefetch hit share,
   ``gather_io_ms``, ``scatter_io_ms``, the allocation of the row files
   against the rows touched, the resident set), a run state after round
   4 and a resume bit-exact at round 8 with a byte flipped on disk
   repaired from the snapshot, ``--inject_io_fault
   eio=0.02,short=0.01,torn=0.01`` over rounds 5-8 bit-identical, and
   a ``flip=0.01`` drill with ``--io_scrub_rows 8`` whose detections,
   repairs and ``io_corrupt`` watch alert land in the event log; (4)
   local top-k with dense local error and momentum at 3,500 clients
   (183.9 GB) on the tier the planner picks: 64 count passes a round.
15. the open-world service (``phase_service``; its children run with a
   ``sitecustomize.py`` that holds cuDNN deterministic and writes their
   launch counts at exit): (A) ``python -m commefficient_torch.cv_train``
   at the headline's full width with telemetry on, 200 iid clients under
   ``--churn join=2,depart=1.5,init=0.5,seed=3`` and a run state every 5
   rounds (2 kept), (i) alone: 2 / 1 / 8 launches a round, every
   heartbeat with ``population=``, the churn audit ok; (ii) under ``python
   -m commefficient_torch.scripts.supervise`` with a SIGKILL at a seeded
   heartbeat round, while ``python -m commefficient_torch.scripts.serve``
   follows the checkpoint directory under a query every 0.2 s: the final
   weights bit-equal to (i), one relaunch with ``--resume auto``, the same
   audit, the replica swapped, its versions monotone, every file its
   lease named present whenever read, finite answers; the served over
   solo wall ratio printed (data); (B) phase 14's sketch-local round at
   128 clients on disk under ``--churn
   join=1,depart=0.7,init=0.6,seed=3,compact=4`` for 16 rounds with a
   save every 5, through ``cv_train.main`` in this process: 10 / 1 / 8
   launches a round, ``rows_retired`` and ``rows_compacted`` in the log,
   the directory checked against the masks after every save, each
   compaction's ms and bytes moved, and a resume from the last save
   after a compaction bit-equal to the continuous run; (C) two tenants of
   10 headline rounds under ``python -m
   commefficient_torch.scripts.orchestrate --max-concurrent 2``: the
   second admitted after the first's first heartbeat, admitted =
   finished + gave up, each tenant's weights bit-equal to a solo run of
   the same command.
16. the 2-D (clients x shard) plane (``phase_grid``): four gloo ranks on
   ``cuda:0`` (two NCCL ranks cannot share a card; gloo stages every
   collective through the host, so nothing here measures NVLink), the
   process group numbered by the tuple index as ``cv_train`` starts it,
   ``COMMEFFICIENT_FORCE_DCN_AXIS=clients`` and cuDNN deterministic: (a)
   the headline round under ``--server_shard --num_devices 2
   --shard_devices 2`` (fp32) bit-equal on every rank to the same ranks
   as one clients axis (``--num_devices 4``), 2 / 1 / 8 launches a round
   on each rank (rank 3 at ``t0 = 12``: two valid chunks and a padded
   tail), 1 / 1 / 8 / 1 under ``--fused_epilogue``; (b)
   ``--collective_plan table=shard:fp32/clients:int8,downlink=dcn:int8``
   for 3 rounds: finite, the ranks equal, within 5% of the fp32 run's
   weights (the JAX package's bound), the carries tuples with None at the
   fp32 level, and each quantized level's error-feedback identity on the
   card (``GRID_EF_RTOL``); (c) ``uncompressed`` under
   ``uplink=shard:fp32/clients:int8`` for 2 rounds: finite, the ranks
   equal; (d) the 2-D run state after round 1 restored on the 1-D
   four-rank plane: round 2's weights and server state bit-equal to the
   2-D run's; (e) ``torchrun --nproc_per_node 1 -m
   commefficient_torch.cv_train --server_shard --collective_plan auto``
   with telemetry: exit 0, finite losses, the probe's report (round trips
   timed on the card) and its plan in ``run_start``. Rounds/sec of the
   2-D, the 1-D and the per-axis round in alternating triples (data).
17. GPT-2's sequence parallelism (``phase_seq``) at GPT-2-small's full
   width (phase 9's round, dropout 0, T = 256) on gloo ranks on
   ``cuda:0``: (a) the one-rank round in this process, its summed
   gradient and losses; (b) two ranks as (clients 1) x (seq 2) under
   ``--seq_parallel ring``, then ``ulysses``: round 1's summed gradient
   within ``SEQ_GRAD_ATOL`` / ``SEQ_GRAD_RTOL`` and its losses within
   ``SEQ_LOSS_RTOL`` of the one-rank round's, 2 finite rounds, both
   ranks' weights bit-equal (their SHA-256), 2 / 1 / 8 launches of the
   accumulate, the query and the count pass a round on each rank; (c)
   meanwhile two more ranks run ``gpt2_train`` under ``--seq_parallel
   ring --bf16`` (finite val NLL, the ranks alike, the headline kernels
   launched); (d) four ranks as (clients 2) x (seq 2) under ring: 2
   finite rounds, the four ranks' weights bit-equal, 2 / 1 / 8 launches;
   (e) tokens/sec of the (clients 2) x (seq 2) round beside the one-rank
   round's (data: gloo stages the 497.8 MB gradient sum through the host).
18. GPT-2's tensor parallelism and experts (``phase_tp_ep``) at
   GPT-2-small's full width (phase 9's round, dropout 0) and its MoE
   variant (4 experts on every other block, d = 209,466,625, Tn = 419) on
   gloo ranks on ``cuda:0``: the one-rank dense (phase 17's) and MoE
   rounds in this process (their summed gradients, losses and
   tokens/sec); the six
   kernels against their plain versions at the MoE geometry, exact; one
   MoE layer at full width on one client's 1,024 tokens, sparse dispatch
   at capacity factor 4 equal to dense dispatch and at 1.25 dropping the
   tokens the plain CPU computation drops; (a) two ranks as (clients 1)
   x (model 2) and (c) two more as (clients 1) x (expert 2) on the MoE
   model, side by side: round 1's summed gradient and losses against the
   one-rank round's (``SEQ_GRAD_*``, ``SEQ_LOSS_RTOL``), MP_ROUNDS finite
   rounds with 2 / 1 / 8 launches a rank, both ranks bit-equal, then each
   pair's MP_TIMED_ROUNDS timed rounds with the card to itself; (b) four
   ranks as (seq 2) x (model 2) under ring: MP_GRID_ROUNDS finite
   rounds, the four ranks bit-equal, 2 / 1 / 8; (e) ``gpt2_train
   --model_devices 2 --n_experts 4 --expert_devices 2`` on the four as
   (model 2) x (expert 2): a finite val NLL alike on every rank, the
   headline kernels launched, its tokens/sec; (f) tokens/sec of (a), (c)
   and (e) beside the one-rank rounds' (data).
19. GPT-2's pipeline (``phase_pp``) at GPT-2-small's full width and depth
   (phase 9's round, dropout 0, ``--pp_microbatches 2``) and on phase
   18's MoE model (6 layers a stage, its aux at one microbatch) on gloo
   ranks on ``cuda:0``, against phase 17's and phase 18's one-rank rounds:
   (a) two ranks as (clients 1) x (stage 2) and (b) two more as (clients
   1) x (stage 2) on the MoE model, side by side: round 1's summed
   gradient and losses against the one-rank round's (``SEQ_GRAD_*``,
   ``SEQ_LOSS_RTOL``), PP_ROUNDS finite rounds with 2 / 1 / 8 launches a
   rank, both ranks bit-equal, then each pair's PP_TIMED_ROUNDS timed
   rounds with the card to itself; (c) four ranks as (stage 2) x (model
   2), then as (seq 2) x (stage 2) under ring: PP_GRID_ROUNDS finite
   rounds each, the four ranks bit-equal, 2 / 1 / 8;
   (d) ``gpt2_train --pipeline_devices 2`` on two ranks: a finite val NLL
   alike on both, the headline kernels launched, its tokens/sec; (e)
   tokens/sec of (a), (b) and (d) beside the one-rank rounds' (data).

Then one JSON line of the kernels (launches per timed window of the path
that runs each: phase 4 for the accumulate, the query and the count pass,
phase 5 for the running accumulate, the epilogue and the descent; and a
``sharded`` object each: its launches a round per rank on phase 11's
sharded round and its largest error at ``t0 > 0``; its launches a
round on rank 3 of phase 16's 2-D round; on a rank of phase 17's
(clients 2) x (seq 2) grid; on a rank of phase 18's (clients 1) x
(model 2) round, with its largest error at the MoE geometry; on a rank of
phase 19's (clients 1) x (stage 2) round), the
card's line, and ``{"ok": true, "device": {...}}`` as the last line.
Without a card it exits with an error before printing any result.

``--kernel-times`` runs none of the phases. It times, for the checkout
that holds the script, the accumulate pair and the query over full chunk
ranges at ``r`` in {1, 5} and ``Tn`` in {1, 3, 14} (the query flushed
and warm), the round's masked query (``estimates_chunks``), the count
pass at the first and the last pass's thresholds and the fused epilogue
at the headline geometry, and the descent over 7,001,344 patterns at
k = 50,000 with ``torch.topk`` and ``torch.kthvalue`` beside it, one JSON
line each (with names, only those rows). It uses only entry points that
the port has had since its second slice, so
to compare two checkouts on one card, copy
this file into the other's root (for example the parent commit unpacked
with ``git archive`` into a gitignored directory) and run the two copies
in turns: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

from commefficient_torch import kernels
from commefficient_torch.config import parse_args
from commefficient_torch.federated import FedModel, FedOptimizer, LambdaLR
from commefficient_torch.federated.checkpoint import (
    load_run_state,
    save_round_state,
)
from commefficient_torch.federated.engine import PipelinedRoundEngine
from commefficient_torch.federated.losses import (
    make_cv_losses,
    make_gpt2_losses,
)
from commefficient_torch.federated.rounds import ClientStates
from commefficient_torch.federated.server import (
    init_server_state,
    round_health,
    server_update,
)
from commefficient_torch.federated.worker import microbatch_plan
from commefficient_torch.models import GPT2DoubleHeads, ResNet9
from commefficient_torch.ops.flat import ChunkLayout
from commefficient_torch.parallel.pipeline import make_gpt2_pp_losses
from commefficient_torch.ops import sketch as tsk
from commefficient_torch.ops import topk as ttk
from commefficient_torch.profiling import host_sync_monitor
from commefficient_torch.telemetry import (
    DEFAULT_WATCH_RULES,
    METRIC_FIELDS,
    RunTelemetry,
    WatchEngine,
    device_round_metrics,
    parse_watch_rules,
    read_events,
)
from commefficient_torch.utils import PiecewiseLinear

HEADLINE = ["--mode", "sketch", "--error_type", "virtual",
            "--local_momentum", "0", "--virtual_momentum", "0.9",
            "--num_rows", "5", "--num_cols", "500000", "--k", "50000",
            "--num_workers", "8", "--local_batch_size", "8",
            "--dataset_name", "CIFAR10", "--device", "cuda",
            "--no_telemetry"]
OPT_IN = ["--stream_sketch", "--sketch_coalesce", "--fused_epilogue"]
TIMED_ROUNDS = 20
HEADLINE_KERNELS = ("sketch_accumulate", "sketch_estimates", "topk_count_ge")
OPT_IN_KERNELS = ("sketch_accumulate_into", "fused_epilogue", "topk_descent")
REPS = 30
# the plain PyTorch versions (milliseconds each at the large geometries)
PLAIN_REPS = 10

_FLUSH = {}


def flush_l2() -> None:
    """Read 96 MB, twice the H100's 50 MB L2, so the timed launch finds none
    of its data there. A read leaves clean lines, which the launch evicts
    for free; a write (``zero_``) would leave up to 50 MB of dirty lines
    whose write-back the launch would pay for."""
    buf = _FLUSH.get("buf")
    if buf is None:
        buf = _FLUSH["buf"] = torch.zeros(96 << 20, dtype=torch.uint8,
                                          device="cuda")
    buf.max()


def time_ms(fn, reps: int = REPS, flush: bool = True) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` launches, after 3
    warm-up calls, with L2 flushed before each launch (or not: then the
    launch finds in L2 what the one before it left there). The card spins
    for about 0.1 ms (``torch.cuda._sleep``, which touches no memory)
    before the start event, so the host has enqueued the launch by the time
    the card reaches it and no host time enters the measurement."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush:
            flush_l2()
        torch.cuda._sleep(200_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    """(bytes/s, float32 op/s, int32 op/s) of the card.

    Memory and float32 rates are NVIDIA's data-sheet numbers. The data
    sheets give no int32 rate; this one is the rate of the ALU pipe, which
    alone runs the right shifts and the logic ops (SHF, LOP3): the Hopper
    SM's 64 INT32 lanes (the Hopper architecture white paper: 64 INT32
    units per SM, against 128 FP32) times the SM count times the maximum SM
    clock that ``nvidia-smi`` reports: 64 x 132 x 1,980 MHz = 16.7 T int32
    op/s on an H100 SXM. Integer multiplies (IMAD), and the adds and left
    shifts that the compiler moves there, run on the FMA pipe beside it,
    and the SM issues 4 warp instructions a clock (128 lanes) over all its
    pipes, so an int32 count charged at this rate must be of ALU-pipe ops,
    or half the instructions of any kind (see ``HASH_ALU_OPS``)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int32 = 64 * sms * mhz * 1e6
    if "PCIe" in name:
        return 2.0e12, 51e12, int32
    if "NVL" in name:
        return 3.9e12, 60e12, int32
    if "H200" in name:
        return 4.8e12, 67e12, int32
    return 3.35e12, 67e12, int32  # H100 SXM


def nan_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(torch.nan_to_num(a, nan=0.0),
                                torch.nan_to_num(b, nan=0.0)))


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal NaN positions, and equal bit patterns (zero signs included)
    everywhere else."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))
                and torch.equal(a.view(torch.int32)[~nan],
                                b.view(torch.int32)[~nan]))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    fa = a.to(torch.float64)
    fb = b.to(torch.float64)
    both = torch.isfinite(fa) & torch.isfinite(fb)
    if not both.any():
        return 0.0
    return float((fa[both] - fb[both]).abs().max())


def special(x: torch.Tensor) -> torch.Tensor:
    flat = x.view(-1)
    flat[3] = float("nan")
    flat[5] = float("inf")
    flat[8] = float("-inf")
    flat[11:40] = 1e-40
    flat[41] = -0.0
    return x


def bound(nbytes: float, int_ops: float, flops: float, peak) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the card's rate for their
    type (int32 and float32 run on their own lanes, so the slower of the
    two)."""
    bw, frate, irate = peak
    tb, to = nbytes / bw, max(int_ops / irate, flops / frate)
    return {"bound_ms": 1e3 * max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations"}


# The int32 work of one sign hash and its use, per (row, coordinate),
# charged at the ALU pipe's rate (``peaks``). As the source writes it a hash
# is 12 int32 ops: the coordinate (chunk base + position, 1), idx ^ key
# (1), x ^= x >> 16 (2), x *= M1 (1), x ^= x >> 13 (2), x *= M2 (1), bit 0
# of x ^ x >> 16 (2), that bit into the value's sign bit (2); and the
# float add. The fewest of them that must run on the ALU pipe: 2 for the
# key and the first xor-shift (idx >> 16, then one LOP3 of idx, idx >> 16
# and the row's key ^ key >> 16, computed once), 2 for the second
# xor-shift (SHF, LOP3), 2 for the sign (one LOP3 for ~(a ^ b) & 0x80000000
# of a = x << 31 and b = x << 15, one LOP3 into the value). The other 6
# (the two multiplies, those two left shifts as IMAD.SHL, the coordinate
# add, the float add) go to the FMA pipes. 12 instructions a hash over the
# SM's 128 issue lanes a clock take as long as 6 over the ALU's 64, so
# either way the bound is 6 ops a hash at 64 lanes x SMs x clock.
HASH_ALU_OPS = 6

# The query's ALU-pipe ops. All its rows hash the same coordinate, so
# fmix32's first xor-shift is taken once per coordinate: its xor (1; the
# shift can run as IMAD.HI on the FMA pipe). Per (row, coordinate): the
# xor with the row's folded key (1), the second xor-shift's xor (1) and
# the sign flip (1); the sign bit itself comes out of one multiply
# (csrc/sketch_common.cuh::sign_word). The median's min and max run on the
# ALU pipe too (64 a clock per SM, the CUDA guide's rate for compare,
# minimum and maximum): 10 at R = 5, 4 at R = 3, the bubble network's
# R (R - 1) at other R.
QUERY_ALU_OPS_COORD = 1
QUERY_ALU_OPS_ROW = 3
MEDIAN_MIN_MAX = {r: 10 if r == 5 else 4 if r == 3 else r * (r - 1)
                  for r in range(1, 9)}


def mask_past(est, t0, n_valid):
    """``mask_tail`` by global coordinate, written out: +0.0 at every
    position of the chunks from ``t0`` whose coordinate is >= n_valid."""
    coord = t0 * est.shape[1] * 128 + torch.arange(
        est.numel(), device=est.device).view(est.shape)
    return torch.where(coord < n_valid, est,
                       torch.zeros((), dtype=est.dtype, device=est.device))


def plain_estimates(table3, cs_, t0=0, Tn=None, n_valid=None):
    est = tsk._sketch_estimates_plain(table3, cs_.inv_q, cs_.inv_w,
                                      cs_.sign_keys, t0)
    return est if n_valid is None else mask_past(est, t0, n_valid)


@contextlib.contextmanager
def plain_kernels():
    """Every kernel's dispatch point swapped for its plain version, on the
    card; no kernel may launch inside."""
    with contextlib.ExitStack() as stack:
        for mod, name, fn in (
                (tsk, "sketch_accumulate", tsk._sketch_accumulate_plain),
                (tsk, "sketch_accumulate_into",
                 tsk._sketch_accumulate_into_plain),
                (tsk, "sketch_segment_into", tsk._sketch_segment_into_plain),
                (tsk, "sketch_estimates", plain_estimates),
                (tsk, "fused_epilogue", tsk._fused_epilogue_plain),
                (ttk, "topk_count_ge", ttk._count_ge_plain),
                (ttk, "topk_descent", ttk._descent_plain)):
            stack.enter_context(mock.patch.object(mod, name, fn))
        before = kernels.launch_counts()
        yield
        assert kernels.launch_counts() == before, "plain path launched"


# Thresholds beyond the descent's sorted p + (j << shift): unsorted, with
# repeats, 0, negative ones and 0x7FFFFFFF; and all 0x7FFFFFFF
COUNT_THRESHOLDS = {
    "mixed": [0x3F400000, 0, 0x7F800000, 0x3F400000, 1, 0x7FFFFFFF, -5,
              0x3E800000, 0x00800000, 0x3F400000, 0x7F7FFFFF, 0x100,
              0x3F000000, -2**31, 0x40400000, 0x3F400001],
    "all 0x7FFFFFFF": [0x7FFFFFFF] * 16}


def check_count_cases(bits, est, label):
    """The count pass's contract beyond the descent, each case exact:
    ``COUNT_THRESHOLDS`` and 16 of the data's own magnitudes in random
    order, on the whole, on views at a 4-byte offset, on 1, 3 and 129
    patterns and on NaN, inf and subnormal patterns; then two launches back
    to back on different inputs (the kernel's scratch totals and ticket
    must come back to zero between them)."""
    dev = bits.device
    gen = torch.Generator().manual_seed(bits.numel())
    pick = torch.randint(0, bits.numel(), (16,), generator=gen).to(dev)
    sets = {name: torch.tensor(ts, dtype=torch.int32, device=dev)
            for name, ts in COUNT_THRESHOLDS.items()}
    sets["own magnitudes"] = ttk._mag(bits)[pick]
    sp = special(est.clone()).reshape(-1).view(torch.int32)
    views = {"whole": bits, "bits[1:]": bits[1:], "n = 1": bits[:1],
             "n = 3 at offset 1": bits[1:4], "n = 129": bits[:129],
             "n = 129 at offset 3": bits[3:132], "special": sp}
    for vname, b in views.items():
        for tname, ts in sets.items():
            assert torch.equal(kernels.topk_count_ge(b, ts),
                               ttk._count_ge_plain(b, ts)), \
                f"{label}: topk_count_ge on {vname}, {tname} thresholds"
    first = kernels.topk_count_ge(bits, sets["mixed"])
    second = kernels.topk_count_ge(sp[1:], sets["own magnitudes"])
    assert torch.equal(first, ttk._count_ge_plain(bits, sets["mixed"])) \
        and torch.equal(second, ttk._count_ge_plain(
            sp[1:], sets["own magnitudes"])), \
        f"{label}: topk_count_ge launched twice back to back"


def check_kernels(card: str, d, c, r, t0, seed, label, timed, k=None):
    """Phase 3 for one geometry: every kernel against its plain version.
    ``k``: the top-k size of the timed descent (default 1/140 of the
    padded size, ResNet9's 50,000 at its geometry)."""
    peak = peaks(card)
    dev = torch.device("cuda")
    cs = tsk.make_sketch(d, c, r, seed=seed, device=dev)
    Tn = cs.T - t0
    c_pad, S = cs.c_pad, cs.sublanes
    gen = torch.Generator().manual_seed(seed)
    v3 = torch.randn((Tn, S, 128), generator=gen)
    if t0 == 0:
        v3 = cs.chunk_layout.chunk(cs.chunk_layout.unchunk(v3))  # zero tail
    if not timed:
        v3 = special(v3)
    v3 = v3.to(dev)
    q, w = tsk._shift_cols(cs.shift_q, cs.shift_w, t0, Tn)
    iq, iw = tsk._shift_cols(cs.inv_q, cs.inv_w, t0, Tn)
    keys = cs.sign_keys
    results = {}

    def record(name, got, want, nbytes, int_ops, flops, kernel_fn=None,
               plain_fn=None, library_fn=None):
        results[name] = dict(max_abs_err=max_abs_err(got, want),
                             **bound(nbytes, int_ops, flops, peak))
        if timed:
            results[name]["ms"] = time_ms(kernel_fn)
            results[name]["plain_ms"] = time_ms(plain_fn, reps=PLAIN_REPS)
            results[name]["library_ms"] = (time_ms(library_fn)
                                           if library_fn else None)

    # accumulate
    got = kernels.sketch_accumulate(v3, q, w, keys, t0)
    want = tsk._sketch_accumulate_plain(v3, q, w, keys, t0)
    torch.cuda.synchronize()
    assert nan_equal(got, want), f"{label}: sketch_accumulate != plain"
    hashes = r * Tn * c_pad  # one sign hash per (row, coordinate)
    record("sketch_accumulate", got, want,
           4 * (v3.numel() + got.numel() + 2 * q.numel() + r),
           HASH_ALU_OPS * hashes, 2 * hashes,
           lambda: kernels.sketch_accumulate(v3, q, w, keys, t0),
           lambda: tsk._sketch_accumulate_plain(v3, q, w, keys, t0))

    # running accumulate from a random incoming table: the chunk range's
    # full width (the weight-decay launch), then an unaligned segment that
    # straddles a chunk boundary (a coalesced group's launch)
    tbl3 = torch.randn((r, S, 128), generator=gen)
    if not timed:
        tbl3 = special(tbl3)
    tbl3 = tbl3.to(dev)
    got = kernels.sketch_accumulate_into(tbl3, v3, q, w, keys, t0)
    want = tsk._sketch_accumulate_into_plain(tbl3, v3, q, w, keys, t0)
    torch.cuda.synchronize()
    assert bit_equal(got, want), f"{label}: sketch_accumulate_into != plain"
    seg_a = t0 * c_pad + 137
    seg_b = min(t0 * c_pad + c_pad + 50_011, d)
    seg = v3.reshape(-1)[seg_a - t0 * c_pad:seg_b - t0 * c_pad]
    cs_cpu = tsk.make_sketch(d, c, r, seed=seed, device="cpu")
    seg_got = tsk.sketch_segment_accum(cs, tbl3.view(r, c_pad), seg, seg_a)
    seg_want = tsk.sketch_segment_accum(cs_cpu, tbl3.view(r, c_pad).cpu(),
                                        seg.cpu(), seg_a)
    assert bit_equal(seg_got.cpu(), seg_want), \
        f"{label}: segment [{seg_a}, {seg_b}) on the card != plain on the CPU"
    # the segment form read in place against its plain version (the
    # segment padded to its covering chunks), at the straddling segment and
    # at one that ends at d, inside the last chunk's padded tail
    for a, b in ((seg_a, seg_b), (d - c_pad - 7, d)):
        x = v3.reshape(-1)[a - t0 * c_pad:b - t0 * c_pad]
        tbl = tbl3.view(r, c_pad)
        got_s = tsk.sketch_segment_into(cs, tbl, x, a)
        want_s = tsk._sketch_segment_into_plain(cs, tbl, x, a)
        torch.cuda.synchronize()
        assert bit_equal(got_s, want_s), \
            f"{label}: segment form [{a}, {b}) != padded plain"
    record("sketch_accumulate_into", got, want,
           4 * (v3.numel() + 2 * got.numel() + 2 * q.numel() + r),
           HASH_ALU_OPS * hashes, 2 * hashes,
           lambda: kernels.sketch_accumulate_into(tbl3, v3, q, w, keys, t0),
           lambda: tsk._sketch_accumulate_into_plain(tbl3, v3, q, w, keys,
                                                     t0))

    # query: unmasked, then masked at d as the round calls it (+0.0 at
    # every coordinate >= d, bit for bit), on the table and, untimed, on a
    # table half of whose cells are zero (ties at zero)
    table3 = want if timed else special(want.clone())
    got = kernels.sketch_estimates(table3, q, w, keys, t0)
    want = tsk._sketch_estimates_plain(table3, iq, iw, keys, t0)
    torch.cuda.synchronize()
    assert nan_equal(got, want), f"{label}: sketch_estimates != plain"
    tables = {"table": table3}
    if not timed:
        zero = torch.rand(table3.shape, generator=gen).to(dev)
        tables["half-zero table"] = torch.where(
            zero < 0.25, torch.zeros((), device=dev), torch.where(
                zero < 0.5, torch.full((), -0.0, device=dev), table3))
    for tname, tbl in tables.items():
        got_m = kernels.sketch_estimates(tbl, q, w, keys, t0, d)
        want_u = tsk._sketch_estimates_plain(tbl, iq, iw, keys, t0)
        want_m = mask_past(want_u, t0, d)
        if t0 == 0:
            assert bit_equal(want_m, cs.chunk_layout.mask_tail(want_u))
        torch.cuda.synchronize()
        tail = mask_past(torch.ones_like(want_u), t0, d) == 0
        assert not got_m[tail].view(torch.int32).any(), \
            f"{label}: masked sketch_estimates tail not +0.0 ({tname})"
        assert nan_equal(got_m, want_m), \
            f"{label}: masked sketch_estimates != mask_tail(plain) ({tname})"
    # the operations the function needs, for the coordinates below d (the
    # kernel neither gathers nor hashes a masked cell)
    nv = min(max(d - t0 * c_pad, 0), Tn * c_pad)
    record("sketch_estimates", got_m, want_m,
           4 * (table3.numel() + got_m.numel() + 2 * q.numel() + r),
           (QUERY_ALU_OPS_COORD + QUERY_ALU_OPS_ROW * r + MEDIAN_MIN_MAX[r])
           * nv, (2 if r % 2 == 0 else 0) * nv,
           lambda: kernels.sketch_estimates(table3, q, w, keys, t0, d),
           lambda: mask_past(tsk._sketch_estimates_plain(
               table3, iq, iw, keys, t0), t0, d))

    # the estimate plane of the server phase, and its top-k size
    est = cs.chunk_layout.mask_tail(want) if t0 == 0 else want
    if not timed:
        # NaN, inf and subnormal estimates, and ties at the threshold: 40
        # cells of one magnitude, k reaching into them
        flat = special(est).view(-1)
        flat[100:130] = 0.75
        flat[130:140] = -0.75
        flat.view(torch.int32)[7] = 0xFFC00123 - 2**32  # -NaN, a payload
        mags = torch.where(torch.isnan(flat), torch.zeros_like(flat),
                           flat.abs())
        k = int((mags > 0.75).sum()) + 20
    else:
        k = k or max(1, est.numel() // 140)
    bits = est.reshape(-1).view(torch.int32)
    n = bits.numel()

    # count passes: the whole descent, each pass against the plain count
    p = torch.zeros((), dtype=torch.int32, device=dev)
    for shift in range(28, -1, -4):
        ts = ttk._pass_thresholds(p, shift)
        got_c = kernels.topk_count_ge(bits, ts)
        want_c = ttk._count_ge_plain(bits, ts)
        assert torch.equal(got_c, want_c), f"{label}: topk_count_ge != plain"
        p = p + ((want_c >= k).sum().to(torch.int32) << shift)
    assert int(ttk.resolve_threshold(est, k)) == int(p)
    if not timed:
        assert int(p) == int(torch.tensor(0.75).view(torch.int32)), label
    check_count_cases(bits, est, label)
    ts0 = ttk._pass_thresholds(torch.zeros((), dtype=torch.int32,
                                           device=dev), 28)
    # the operations the function needs: a bucket search over the 16
    # sorted thresholds (sign mask, 4 compare-and-select steps, one
    # shared-memory increment), 10 int32 ops per element; the kernel's
    # search compiles to about twice that
    record("topk_count_ge", got_c.float(), want_c.float(),
           4 * (n + 32), 10 * n, 0,
           lambda: kernels.topk_count_ge(bits, ts0),
           lambda: ttk._count_ge_plain(bits, ts0))

    # the one-launch descent against the per-pass descent and the plain
    # one; the library call is torch.topk of the magnitudes (it splits the
    # slice over many blocks), with torch.kthvalue (one block) beside it
    got_p = kernels.topk_descent(bits, k)
    want_p = ttk._descent_plain(bits, k)
    torch.cuda.synchronize()
    assert int(got_p) == int(want_p) == int(p), \
        f"{label}: topk_descent {int(got_p)} != plain {int(want_p)} / " \
        f"per-pass {int(p)}"
    mags = ttk._mag(bits)
    if k <= n:
        kth = torch.kthvalue(mags, n - k + 1).values
        assert int(kth) == int(p), f"{label}: kthvalue {int(kth)} != {int(p)}"
    # a view whose start is not 16-byte aligned, k at and past n, and one
    # bin only (all equal, all zero)
    for case, b, kk in (
            ("bits[1:]", bits[1:], k), ("k = n", bits, n),
            ("k > n", bits, n + 1),
            ("all equal", torch.full_like(bits, 0x3F400000), k),
            ("all zero", torch.zeros_like(bits), k)):
        got_e, want_e = kernels.topk_descent(b, kk), ttk._descent_plain(b, kk)
        torch.cuda.synchronize()
        assert int(got_e) == int(want_e), \
            f"{label}: topk_descent at {case}: {int(got_e)} != {int(want_e)}"
    # the operations the function needs, not the old kernel's 8 passes of
    # 15 candidates: a histogram radix select in 3 passes of 11-bit digits,
    # 6 int32 ops per element and pass (sign mask, prefix shift and
    # compare, digit shift and mask, one shared-memory increment)
    record("topk_descent", got_p.float(), want_p.float(),
           4 * (n + 1), 3 * 6 * n, 0,
           lambda: kernels.topk_descent(bits, k),
           lambda: ttk._descent_plain(bits, k),
           lambda: torch.topk(mags, k, sorted=False))
    if timed:
        results["topk_descent"]["kthvalue_ms"] = time_ms(
            lambda: torch.kthvalue(mags, n - k + 1), reps=2)

    # fused epilogue at the resolved threshold: against its plain version
    # (the composed mask and accumulate), on the chunk range and, on a
    # range from chunk 3, at t0 != 0
    got_u, got_t = kernels.fused_epilogue(est, p, q, w, keys, t0)
    want_u, want_t = tsk._fused_epilogue_plain(est, p, q, w, keys, t0)
    torch.cuda.synchronize()
    assert bit_equal(got_u, want_u), f"{label}: fused_epilogue update"
    assert bit_equal(got_t, want_t), f"{label}: fused_epilogue table"
    if Tn > 3:
        q3, w3 = tsk._shift_cols(cs.shift_q, cs.shift_w, t0 + 3, Tn - 3)
        sub = est[3:].contiguous()
        u3, t3 = kernels.fused_epilogue(sub, p, q3, w3, keys, t0 + 3)
        pu3, pt3 = tsk._fused_epilogue_plain(sub, p, q3, w3, keys, t0 + 3)
        torch.cuda.synchronize()
        assert bit_equal(u3, pu3) and bit_equal(t3, pt3), \
            f"{label}: fused_epilogue at t0 = {t0 + 3}"
    # the update is the masked estimates themselves, NaN payloads included
    assert torch.equal(got_u.view(torch.int32), want_u.view(torch.int32)), \
        f"{label}: fused_epilogue update bits"
    # every estimate kept, and none but the NaNs
    for p_x in (0, 0x7F800001):
        pt = torch.tensor(p_x, dtype=torch.int32, device=dev)
        u_x, t_x = kernels.fused_epilogue(est, pt, q, w, keys, t0)
        pu_x, pt_x = tsk._fused_epilogue_plain(est, pt, q, w, keys, t0)
        torch.cuda.synchronize()
        assert torch.equal(u_x.view(torch.int32), pu_x.view(torch.int32)), \
            f"{label}: fused_epilogue update at p = {p_x:#x}"
        assert bit_equal(t_x, pt_x), \
            f"{label}: fused_epilogue table at p = {p_x:#x}"
    # the operations the function needs: one mask test per coordinate and
    # one sign hash and add per kept nonzero estimate and row (the adds of
    # zeros change no bit, see csrc/sketch_kernels.cu)
    kept = int(((want_u.view(torch.int32) & 0x7FFFFFFF) != 0).sum())
    record("fused_epilogue", torch.cat([got_u.reshape(-1),
                                        got_t.reshape(-1)]),
           torch.cat([want_u.reshape(-1), want_t.reshape(-1)]),
           4 * (2 * est.numel() + got_t.numel() + 2 * q.numel() + r + 1),
           2 * est.numel() + HASH_ALU_OPS * r * kept, 2 * r * kept,
           lambda: kernels.fused_epilogue(est, p, q, w, keys, t0),
           lambda: tsk._fused_epilogue_plain(est, p, q, w, keys, t0))
    return results


def synthetic_batch(seed: int = 0):
    rng = np.random.RandomState(seed)
    return {"inputs": rng.randn(8, 8, 32, 32, 3).astype(np.float32),
            "targets": rng.randint(0, 10, size=(8, 8)).astype(np.int64),
            "mask": np.ones((8, 8), np.float32),
            "client_ids": np.arange(8, dtype=np.int32),
            "worker_mask": np.ones(8, np.float32)}


def build_round(extra, num_clients: int = 64):
    """FedModel / FedOptimizer / LambdaLR for the headline round plus the
    flags ``extra``; returns ``(args, fm, opt, sched, one_round)``."""
    args = parse_args(argv=HEADLINE + extra + [
        "--num_clients", str(num_clients), "--seed", "0"])
    model = ResNet9(do_batchnorm=args.do_batchnorm)
    train_loss, val_loss = make_cv_losses(model)
    fm = FedModel(model, train_loss, args, val_loss, num_clients=num_clients)
    opt = FedOptimizer(fm, args)
    spe = 50
    schedule = PiecewiseLinear([0, args.pivot_epoch, args.num_epochs],
                               [0, 0.4, 0])
    sched = LambdaLR(opt, lambda step: schedule(step / spe))
    print(f"model d = {fm.grad_size:,}, sketch {fm.sketch.r} x "
          f"{fm.sketch.c_pad} (T = {fm.sketch.T}), k = {args.k}")

    def one_round(batch):
        sched.step()
        out = fm(batch)
        opt.step()
        return out

    return args, fm, opt, sched, one_round


def timed_rounds(one_round, batch, per_round: dict, label: str,
                 n: int = TIMED_ROUNDS):
    """2 warm-up rounds, then ``n`` rounds with the launch counts set to 0
    just before and read just after: they must be ``per_round`` times the
    rounds. Returns ``(counts, rounds/sec)``."""
    for _ in range(2):
        one_round(batch)
    torch.cuda.synchronize()
    masks = []
    mask_tail = ChunkLayout.mask_tail

    def counted_mask_tail(self, c3):
        masks.append(c3.device.type)
        return mask_tail(self, c3)

    with mock.patch.object(ChunkLayout, "mask_tail", counted_mask_tail):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        losses = []
        for _ in range(n):
            losses.append(one_round(batch)[0])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
    # the query kernel writes the padded tail's +0.0 itself
    assert not masks, f"{label}: mask_tail ran {len(masks)} times"
    loss = np.concatenate(losses)
    assert np.all(np.isfinite(loss)), f"{label}: non-finite round loss"
    want = {k.name: per_round.get(k.name, 0) * n for k in kernels.KERNELS}
    assert counts == want, f"{label}: launches {counts}, expected {want}"
    rps = n / wall
    print(f"{label} rounds: {n} timed, {rps:.3f} rounds/sec "
          f"({1e3 / rps:.2f} ms/round), mean loss {loss.mean():.4f}")
    print(f"{label} launches per round: " + json.dumps(
        {k: v // n for k, v in counts.items()}) + ", mask_tail calls: 0")
    return counts, rps


def phase_rounds():
    """Phase 4: the headline round at full width."""
    args, fm, opt, sched, one_round = build_round([])
    batch = synthetic_batch()
    counts, rps = timed_rounds(
        one_round, batch, {"sketch_accumulate": 2, "sketch_estimates": 1,
                           "topk_count_ge": 8}, "headline")

    split = phase_split(fm, opt, sched, batch, "headline")
    split.update(profile_rounds(lambda: one_round(batch)))

    # the server phase exact: one table and state through the kernels and
    # through the plain versions, all on the card
    cs = fm.sketch
    fm.begin_round(synthetic_batch(1))
    table = fm._round_ctx.gradient
    state = opt.server_state
    lr = opt.get_lr()
    upd_k, st_k = server_update(table, state, fm.server_config, lr,
                                sketch=cs, layout=fm.layout)
    with plain_kernels():
        upd_p, st_p = server_update(table, state, fm.server_config, lr,
                                    sketch=cs, layout=fm.layout)
    torch.cuda.synchronize()
    assert nan_equal(upd_k, upd_p), "server update: kernels != plain"
    assert nan_equal(st_k.velocity, st_p.velocity), "velocity differs"
    assert nan_equal(st_k.error, st_p.error), "error differs"
    nnz = int((upd_k != 0).sum())
    print(f"server phase exact: update ({nnz} nonzeros), velocity and "
          "error equal through kernels and plain versions")
    fm._round_ctx = None
    check_zero_sign(fm, lr)
    return counts, rps, split


def check_zero_sign(fm, lr):
    """The headline server step at top-k threshold 0: a table with 2,000
    nonzero cells a row (an estimate is nonzero only where 3 of its 5 cells
    are, so fewer than k are) and the round's weights with a quarter of
    them -0.0 and a quarter +0.0, through the kernels and through the
    plain versions. Every estimate is kept, so the query's free sign of a
    zero median reaches ``ps - update``: the new weights must be equal
    under ==, and differ in at most the sign bit of zero weights."""
    cs, k = fm.sketch, fm.server_config.k
    gen = torch.Generator().manual_seed(11)
    table = torch.zeros(cs.table_shape)
    for j in range(cs.r):
        idx = torch.randperm(cs.c_pad, generator=gen)[:2000]
        table[j, idx] = torch.randn(2000, generator=gen)
    table = table.to(fm.device)
    w = fm.layout.unchunk(fm.ps_weights).clone()
    w[0::4] = -0.0
    w[1::4] = 0.0
    ps3 = fm.layout.chunk(w)
    state = init_server_state(fm.server_config, cs)
    est = tsk.estimates_chunks(cs, table)
    assert int((est != 0).sum()) < k
    assert int(ttk.resolve_threshold(est, k)) == 0, "threshold not 0"
    upd_k, st_k = server_update(table, state, fm.server_config, lr,
                                sketch=cs, layout=fm.layout)
    new_k = ps3 - upd_k
    with plain_kernels():
        upd_p, st_p = server_update(table, state, fm.server_config, lr,
                                    sketch=cs, layout=fm.layout)
        new_p = ps3 - upd_p
    torch.cuda.synchronize()
    for name, a, b in (("update", upd_k, upd_p),
                       ("velocity", st_k.velocity, st_p.velocity),
                       ("error", st_k.error, st_p.error),
                       ("weights", new_k, new_p)):
        assert nan_equal(a, b), f"p = 0 server {name}: kernels != plain"
    sign_only = new_k.view(torch.int32) != new_p.view(torch.int32)
    assert not new_k[sign_only].any() and not new_p[sign_only].any(), \
        "p = 0: weights differ beyond the sign of zero"
    print(f"server phase at p = 0 ({int((est != 0).sum())} nonzero "
          f"estimates, k = {k}): weights equal under ==; "
          f"{int((new_p == 0).sum())} zero weights, "
          f"{int(sign_only.sum())} of them differ in the sign bit")


def phase_split(fm, opt, sched, batch, label: str, n: int = 10) -> dict:
    """Median CUDA-event times of the client and server phases over ``n``
    rounds."""
    client_ms, server_ms = [], []
    for _ in range(n):
        sched.step()
        e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        e[0].record()
        handle = fm.begin_round(batch)
        e[1].record()
        opt.step()
        e[2].record()
        fm.finish_round(handle)
        client_ms.append(e[0].elapsed_time(e[1]))
        server_ms.append(e[1].elapsed_time(e[2]))
    split = {"client_phase_ms": statistics.median(client_ms),
             "server_phase_ms": statistics.median(server_ms)}
    print(f"{label} phase split: " + json.dumps(split))
    return split


def opt_in_per_round(fm, args, examples: int = 8) -> dict:
    """Launches per round of the opt-in round, from the port's own plan:
    one running accumulate per coalesced group and microbatch (of a
    client's ``examples``), one more for weight decay, one query, one
    descent, one epilogue."""
    groups = fm.steps.stream_groups
    assert groups is not None, "the opt-in round has no coalescing plan"
    _, n_iters, _ = microbatch_plan(examples, args.microbatch_size)
    return {"sketch_accumulate_into":
            len(groups) * n_iters + (1 if args.weight_decay else 0),
            "sketch_estimates": 1, "topk_descent": 1, "fused_epilogue": 1}


def phase_opt_in(headline_rps: float):
    """Phase 5: the opt-in round at full width."""
    os.environ[ttk.FUSED_DESCENT_ENV] = "1"
    args, fm, opt, sched, one_round = build_round(OPT_IN)
    segs, groups = fm.steps.stream_segments, fm.steps.stream_groups
    print(f"opt-in plan: {len(segs)} leaves in {len(groups)} groups "
          f"(budget {tsk.coalesce_vmem_budget(fm.sketch):,} B): " +
          json.dumps([[segs[i].path.rsplit("/", 2)[0]
                       for i in range(g.start, g.stop)] for g in groups]))
    per_round = opt_in_per_round(fm, args)
    batch = synthetic_batch()
    counts, rps = timed_rounds(one_round, batch, per_round, "opt-in")
    print(f"rounds/sec: headline {headline_rps:.3f}, opt-in {rps:.3f} "
          f"(ratio {rps / headline_rps:.3f}, same call)")
    prof = phase_split(fm, opt, sched, batch, "opt-in")
    prof.update(profile_rounds(lambda: one_round(batch)))

    # the client table through the kernels and through the plain versions
    # (cuDNN held to deterministic algorithms, so that the gradients are
    # the same in the three runs)
    torch.backends.cudnn.deterministic = True
    tables = []
    for plain in (False, True, False):
        with plain_kernels() if plain else contextlib.nullcontext():
            fm.begin_round(synthetic_batch(1))
            tables.append(fm._round_ctx.gradient)
    torch.backends.cudnn.deterministic = False
    torch.cuda.synchronize()
    assert bit_equal(tables[0], tables[2]), "client phase not reproducible"
    assert bit_equal(tables[0], tables[1]), "client table: kernels != plain"
    print("client table exact through kernels and plain versions")

    # the server phase: kernels against plain versions, and the fused
    # epilogue against the composed pair, from one table and state
    cs = fm.sketch
    table = tables[0]
    state = opt.server_state
    lr = opt.get_lr()
    scfg = fm.server_config
    assert scfg.fused_epilogue
    upd_k, st_k = server_update(table, state, scfg, lr, sketch=cs,
                                layout=fm.layout)
    with plain_kernels():
        upd_p, st_p = server_update(table, state, scfg, lr, sketch=cs,
                                    layout=fm.layout)
    upd_c, st_c = server_update(
        table, state, dataclasses.replace(scfg, fused_epilogue=False), lr,
        sketch=cs, layout=fm.layout)
    torch.cuda.synchronize()
    for name, a, b in (("update", upd_k, upd_p),
                       ("velocity", st_k.velocity, st_p.velocity),
                       ("error", st_k.error, st_p.error)):
        assert nan_equal(a, b), f"opt-in server {name}: kernels != plain"
    for name, a, b in (("update", upd_k, upd_c),
                       ("velocity", st_k.velocity, st_c.velocity),
                       ("error", st_k.error, st_c.error)):
        assert bit_equal(a, b), f"opt-in server {name}: fused != composed"
    est = tsk.estimates_chunks(cs, state.error + table)
    u_f, t_f = tsk.fused_epilogue_chunks(cs, est, args.k)
    u_c = ttk.topk_dense_nd(est, args.k)
    t_c = tsk.sketch_chunks(cs, u_c)
    torch.cuda.synchronize()
    assert bit_equal(u_f, u_c), "fused update != composed update"
    assert bit_equal(t_f, t_c), "fused re-sketch != composed re-sketch"
    print(f"opt-in server phase exact: update ({int((upd_k != 0).sum())} "
          "nonzeros), velocity and error equal through kernels and plain "
          "versions and equal to the composed epilogue; fused re-sketch "
          "equals the composed one bit for bit")
    fm._round_ctx = None
    del os.environ[ttk.FUSED_DESCENT_ENV]
    return counts, rps, prof


ANNOTATIONS = ("fed_round", "fed_drain")


def dev_us(e):
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0))


def device_rows(one_round, n: int, finish=None):
    """``n`` calls of ``one_round`` (then ``finish``, if given) under
    ``torch.profiler``, ending in a device sync: the device-side rows
    (kernels, copies, memsets; the CPU ops that launched them would count
    the same time twice), busiest first, and the wall ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            one_round()
        if finish is not None:
            finish()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # a profiler range's device-side mirror (the engine's "fed_round" and
    # "fed_drain") spans the kernels under it, which would count twice
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and e.key not in ANNOTATIONS
                   and dev_us(e) > 0), key=dev_us, reverse=True)
    return rows, wall_ms


def profile_rounds(one_round, n: int = 5) -> dict:
    """Device time by kernel over ``n`` rounds (torch.profiler), printed
    per round, and the device's busy share of the profiled wall time."""
    rows, wall_ms = device_rows(one_round, n)
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    cats = {"convolution": 0.0, "matmul": 0.0, "port kernels": 0.0,
            "other": 0.0}
    for e in rows:
        name = e.key.lower()
        if any(s in name for s in ("sketch_", "topk_", "fused_epilogue")):
            cats["port kernels"] += dev_us(e)
        elif any(s in name for s in ("conv", "cudnn", "dgrad", "wgrad",
                                     "fprop", "implicit_gemm")):
            cats["convolution"] += dev_us(e)
        elif "gemm" in name or "nvjet" in name:
            cats["matmul"] += dev_us(e)
        elif "xmma" in name:
            cats["convolution"] += dev_us(e)
        else:
            cats["other"] += dev_us(e)
    per_kernel = {k.name: 0.0 for k in kernels.KERNELS}
    for e in rows:
        name = kernel_of(e.key)
        if name:
            per_kernel[name] += dev_us(e) / n / 1e3
    print(f"profile: {n} rounds, wall {wall_ms / n:.3f} ms/round under the "
          f"profiler, device busy {busy_ms / n:.3f} ms/round "
          f"({100 * busy_ms / wall_ms:.1f}%)")
    print("  by category (ms/round): " + json.dumps(
        {k: round(v / n / 1e3, 4) for k, v in cats.items()}))
    for e in rows[:16]:
        print(f"  {dev_us(e) / n / 1e3:8.3f} ms/round  {e.count / n:6.1f} "
              f"calls/round  {e.key[:90]}")
    print("  port kernels (device ms/round): " + json.dumps(per_kernel))
    memsets = sum(e.count for e in rows if "memset" in e.key.lower()) / n
    device_ops = sum(e.count for e in rows) / n
    print(f"  device memsets per round: {memsets:g}, device operations "
          f"(kernels, copies, memsets) per round: {device_ops:g}")
    return {"profiled_busy_ms_per_round": busy_ms / n,
            "profiled_wall_ms_per_round": wall_ms / n,
            "kernel_ms_per_round": per_kernel,
            "memsets_per_round": memsets,
            "device_ops_per_round": device_ops}


# the port's kernel functions as the profiler names them (demangled or not)
KERNEL_SYMBOLS = (
    ("sketch_accumulate_into", ("sketch_accumulate_kernel<true>",
                                "sketch_accumulate_kernelILb1E")),
    ("sketch_accumulate", ("sketch_accumulate_kernel<false>",
                           "sketch_accumulate_kernelILb0E")),
    ("sketch_estimates", ("sketch_estimates_kernel",)),
    ("fused_epilogue", ("fused_epilogue_kernel",)),
    ("topk_count_ge", ("topk_count_ge_kernel",)),
    ("topk_descent", ("topk_descent_kernel",)))


def kernel_of(key: str):
    """The port kernel a profiler row belongs to, or None."""
    for name, symbols in KERNEL_SYMBOLS:
        if any(sym in key for sym in symbols):
            return name
    return None


def phase_cv_train():
    """Phase 6: the CLI entry point, one short epoch and an eval, as the
    headline round and with the opt-in flags."""
    from commefficient_torch import cv_train

    for label, extra, ran in (("headline", [], HEADLINE_KERNELS),
                              ("opt-in", OPT_IN,
                               OPT_IN_KERNELS + ("sketch_estimates",))):
        if extra:
            os.environ[ttk.FUSED_DESCENT_ENV] = "1"
        with tempfile.TemporaryDirectory() as tmp:
            os.environ["COMMEFFICIENT_SYNTHETIC_PER_CLASS"] = "16"
            kernels.reset_launch_counts()
            summary = cv_train.main(HEADLINE + extra + [
                "--dataset_dir", os.path.join(tmp, "cifar10"), "--iid",
                "--num_clients", "16", "--num_epochs", "1", "--seed", "0"])
            counts = kernels.launch_counts()
        os.environ.pop(ttk.FUSED_DESCENT_ENV, None)
        assert summary and np.isfinite(summary["train_loss"]), summary
        assert all((counts[k] > 0) == (k in ran) for k in counts), \
            (label, counts)
        print(f"cv_train {label} row: {json.dumps(summary, default=float)}")
        print(f"cv_train {label} launches: {json.dumps(counts)}")


# phase 7: (name, workers, flags, one-launch descent)
MODES_BASE = ["--num_rows", "5", "--num_cols", "500000", "--k", "50000",
              "--local_batch_size", "8", "--dataset_name", "CIFAR10",
              "--device", "cuda", "--num_clients", "16", "--seed", "0",
              "--no_telemetry"]
VIRTUAL = ["--error_type", "virtual", "--local_momentum", "0",
           "--virtual_momentum", "0.9"]
MODE_CONFIGS = (
    ("c1", 1, ["--mode", "uncompressed"] + VIRTUAL, False),
    ("c2", 8, ["--mode", "true_topk"] + VIRTUAL, False),
    ("c2-one-launch-descent", 8, ["--mode", "true_topk"] + VIRTUAL, True),
    ("local-topk", 8, ["--mode", "local_topk", "--error_type", "local",
                       "--local_momentum", "0.9"], False),
    ("sketch-local", 8, ["--mode", "sketch", "--error_type", "local",
                         "--local_momentum", "0.9",
                         "--virtual_momentum", "0"], False),
    ("fedavg", 8, ["--mode", "fedavg", "--error_type", "none",
                   "--local_momentum", "0", "--local_batch_size", "-1",
                   "--num_fedavg_epochs", "1", "--fedavg_batch_size", "4"],
     False),
)
MODE_TIMED_ROUNDS = 6


def modes_per_round(fm, one_launch_descent: bool) -> dict:
    """Launches per round of a phase-7 config, from the structure of the
    port's round (``federated/rounds.py``, ``server.py``): a top-k is one
    threshold search, 8 count passes or (one-launch descent) one descent;
    ``true_topk`` takes one top-k on the server, ``local_topk`` one in
    each client slot; sketch mode takes one accumulate in each client slot
    on the per-client path (one of the sum on the fused one), the
    server's query, top-k and re-sketch, and with client tables one more
    re-sketch for their keep mask. ``uncompressed`` and ``fedavg`` launch
    none."""
    wcfg, W = fm.worker_config, fm.args.num_workers
    n = dict.fromkeys((k.name for k in kernels.KERNELS), 0)

    def topk(times):
        if one_launch_descent:
            n["topk_descent"] += times
        else:
            n["topk_count_ge"] += 8 * times

    client_tables = wcfg.has_velocity or wcfg.has_error
    if wcfg.mode == "true_topk":
        topk(1)
    elif wcfg.mode == "local_topk":
        topk(W)
    elif wcfg.mode == "sketch":
        per_client = client_tables or wcfg.max_grad_norm is not None
        n["sketch_accumulate"] += (W if per_client else 1) + 1 \
            + (1 if client_tables else 0)
        n["sketch_estimates"] += 1
        topk(1)
    return n


def mode_batches(W: int, n: int = 4):
    """``n`` seeded synthetic batches of W clients x 8 images, the client
    ids drawn from the 16 clients."""
    out = []
    for i in range(n):
        rng = np.random.RandomState(200 + i)
        out.append({
            "inputs": rng.randn(W, 8, 32, 32, 3).astype(np.float32),
            "targets": rng.randint(0, 10, size=(W, 8)).astype(np.int64),
            "mask": np.ones((W, 8), np.float32),
            "client_ids": rng.choice(16, W, replace=False).astype(np.int32),
            "worker_mask": np.ones(W, np.float32)})
    return out


def check_server_step(fm, opt, batch, label: str) -> None:
    """One server step from one round context, through the kernels and
    through the plain versions (client states cloned for each, since the
    scatter is in place): weights, server state and client rows equal."""
    fm.begin_round(batch)
    ctx, lr = fm._round_ctx, opt.get_lr()

    def states():
        return ClientStates(*(None if x is None else x.clone()
                              for x in fm.client_states))

    out_k = fm.steps.server_step(fm.ps_weights, opt.server_state, states(),
                                 ctx, lr, fm._rng)
    with plain_kernels():
        out_p = fm.steps.server_step(fm.ps_weights, opt.server_state,
                                     states(), ctx, lr, fm._rng)
    torch.cuda.synchronize()
    (ps_k, ss_k, cs_k), (ps_p, ss_p, cs_p) = out_k, out_p
    pairs = [("weights", ps_k, ps_p), ("velocity", ss_k.velocity,
                                       ss_p.velocity),
             ("error", ss_k.error, ss_p.error)]
    pairs += [(f"client {n}", a, b) for n, a, b in zip(
        ClientStates._fields, cs_k, cs_p) if a is not None]
    for name, a, b in pairs:
        assert nan_equal(a, b), f"{label} server step {name}: kernels != plain"
    fm._round_ctx = None
    print(f"{label} server step equal through kernels and plain versions: "
          + ", ".join(name for name, _, _ in pairs))


def phase_modes(card: str) -> dict:
    """Phase 7: the other modes at full width."""
    results = {}
    error_vec = None
    for name, W, extra, one_launch in MODE_CONFIGS:
        if one_launch:
            os.environ[ttk.FUSED_DESCENT_ENV] = "1"
        args = parse_args(argv=MODES_BASE + ["--num_workers", str(W)]
                          + extra)
        model = ResNet9()
        train_loss, val_loss = make_cv_losses(model)
        fm = FedModel(model, train_loss, args, val_loss, num_clients=16)
        opt = FedOptimizer(fm, args)
        schedule = PiecewiseLinear([0, args.pivot_epoch, args.num_epochs],
                                   [0, 0.4, 0])
        sched = LambdaLR(opt, lambda step: schedule(step / 50))
        per_round = modes_per_round(fm, one_launch)
        batches = mode_batches(W)

        def one_round(b):
            sched.step()
            out = fm(b)
            opt.step()
            return out

        for i in range(2):
            one_round(batches[i])
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        losses = [one_round(batches[i % len(batches)])[0]
                  for i in range(MODE_TIMED_ROUNDS)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        loss = np.concatenate(losses)
        assert np.all(np.isfinite(loss)), f"{name}: non-finite round loss"
        want = {k: v * MODE_TIMED_ROUNDS for k, v in per_round.items()}
        assert counts == want, f"{name}: launches {counts}, expected {want}"
        rps = MODE_TIMED_ROUNDS / wall
        state_mb = sum(x.numel() * 4 for x in fm.client_states
                       if x is not None) / 1e6
        prof = profile_rounds(lambda: one_round(batches[0]), n=3)
        row = {"phase": "modes", "config": name, "mode": args.mode,
               "workers": W, "rounds_per_sec": rps,
               "ms_per_round": 1e3 / rps, "mean_loss": float(loss.mean()),
               "launches_per_round": per_round,
               "client_state_MB": state_mb,
               "profiled_busy_share": (prof["profiled_busy_ms_per_round"]
                                       / prof["profiled_wall_ms_per_round"]),
               "kernel_ms_per_round": prof["kernel_ms_per_round"],
               "card": card}
        print(json.dumps(row))
        results[name] = row
        check_server_step(fm, opt, batches[0], name)
        if name == "c2":
            error_vec = opt.server_state.error.clone()
        os.environ.pop(ttk.FUSED_DESCENT_ENV, None)
        del fm, opt, sched
        torch.cuda.empty_cache()

    # the count pass on the flat, unpadded vector true_topk hands it (the
    # server's error after c2's rounds): a shape of its own
    bits = error_vec.view(torch.int32)
    n = bits.numel()
    ts = ttk._pass_thresholds(torch.zeros((), dtype=torch.int32,
                                          device=bits.device), 28)
    assert torch.equal(kernels.topk_count_ge(bits, ts),
                       ttk._count_ge_plain(bits, ts)), "flat count pass"
    row = {"phase": "modes", "name": "topk_count_ge", "n": n,
           "ms": time_ms(lambda: kernels.topk_count_ge(bits, ts)),
           "plain_ms": time_ms(lambda: ttk._count_ge_plain(bits, ts)),
           **bound(4 * (n + 32), 10 * n, 0, peaks(card)), "card": card}
    print(json.dumps(row))
    results["flat count pass"] = row
    return results


# phase 8: the run lifecycle
ENGINE_ROUNDS = 16
PAIR_ROUNDS = 24
PAIRS = 2
BN_ROUNDS = 10
HEADLINE_PER_ROUND = {"sketch_accumulate": 2, "sketch_estimates": 1,
                      "topk_count_ge": 8}


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN held to deterministic algorithms (and no autotuning), so that
    two runs of one round give the same gradients bit for bit."""
    old = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = old


def audited_submit(eng, batch, audit: dict):
    """``eng.submit(batch)``; a submit that will not drain runs under
    ``host_sync_monitor(strict=True)``: ``torch.cuda.set_sync_debug_mode(
    "error")`` raises on any call that synchronizes the stream, and the
    counted fetches must be 0."""
    if eng.pending + 1 < eng.drain_every:
        with host_sync_monitor(strict=True) as counter:
            out = eng.submit(batch)
        assert out == [], "a non-drain submit returned results"
        audit["audited"] += 1
        audit["fetches"] += counter.count
        return out
    audit["drains"] += 1
    return eng.submit(batch)


def engine_identity(label, extra, per_round):
    """The round through ``PipelinedRoundEngine(window=2, drain_every=8)``
    for ENGINE_ROUNDS rounds against the synchronous loop from the same
    state: results, weights and server state bit-equal, the non-drain
    submits audited, the launches ``per_round`` a round."""
    batches = [synthetic_batch(s) for s in range(8)]
    args, fm_s, opt_s, _, one_s = build_round(extra)
    if per_round is None:
        per_round = opt_in_per_round(fm_s, args)
    want = [one_s(batches[i % 8]) for i in range(ENGINE_ROUNDS)]
    _, fm_e, opt_e, sched_e, _ = build_round(extra)
    eng = PipelinedRoundEngine(fm_e, opt_e, sched_e, window=2,
                               drain_every=8)
    audit = {"audited": 0, "fetches": 0, "drains": 0}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    got = []
    for i in range(ENGINE_ROUNDS):
        got.extend(audited_submit(eng, batches[i % 8], audit))
    got.extend(eng.drain())
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want_counts = {k.name: per_round.get(k.name, 0) * ENGINE_ROUNDS
                   for k in kernels.KERNELS}
    assert counts == want_counts, f"{label} engine: launches {counts}"
    assert audit["fetches"] == 0, f"{label} engine: fetches between drains"
    assert [r.index for r in got] == list(range(ENGINE_ROUNDS))
    for r, w in zip(got, want):
        for a, b in zip(r.values, w):
            assert a.dtype == b.dtype and np.array_equal(a, b), \
                f"{label} engine: round {r.index} differs from the loop"
    for name, a, b in (("weights", fm_e.ps_weights, fm_s.ps_weights),
                       ("velocity", opt_e.server_state.velocity,
                        opt_s.server_state.velocity),
                       ("error", opt_e.server_state.error,
                        opt_s.server_state.error)):
        assert bit_equal(a, b), f"{label} engine: {name} differs"
    print(f"{label} engine: {ENGINE_ROUNDS} rounds (window 2, drain every "
          f"8) equal to the synchronous loop bit for bit; "
          f"{audit['audited']} non-drain submits under "
          f"set_sync_debug_mode('error'), {audit['fetches']} fetches, "
          f"{eng.window_waits} window waits, {eng.drains} drains; "
          f"launches per round " + json.dumps(
              {k: v // ENGINE_ROUNDS for k, v in counts.items()}))
    del fm_s, opt_s, fm_e, opt_e
    torch.cuda.empty_cache()


def engine_pairs(card, label, extra):
    """Rounds/sec and the device's busy share of the synchronous loop and
    of the engine, on one model, in PAIRS alternating pairs (loop first,
    then engine first, ...). Data, not a claim."""
    _, fm, opt, sched, one_round = build_round(extra)
    batch = synthetic_batch()
    eng = PipelinedRoundEngine(fm, opt, sched, window=2, drain_every=8)
    for _ in range(2):
        one_round(batch)
        eng.submit(batch)
    eng.drain()

    def run(mode):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "sync":
            for _ in range(PAIR_ROUNDS):
                one_round(batch)
        else:
            for _ in range(PAIR_ROUNDS):
                eng.submit(batch)
            eng.drain()
        torch.cuda.synchronize()
        rps = PAIR_ROUNDS / (time.perf_counter() - t0)
        if mode == "sync":
            rows, wall = device_rows(lambda: one_round(batch), 8)
        else:
            rows, wall = device_rows(lambda: eng.submit(batch), 8,
                                     finish=eng.drain)
        return rps, sum(dev_us(e) for e in rows) / 1e3 / wall

    out = {"sync": [], "engine": []}
    for p in range(PAIRS):
        order = ("sync", "engine") if p % 2 == 0 else ("engine", "sync")
        for mode in order:
            rps, busy = run(mode)
            out[mode].append((rps, busy))
    row = {"phase": "lifecycle", "round": label,
           "rounds_per_pair_window": PAIR_ROUNDS,
           "sync_rounds_per_sec": [r for r, _ in out["sync"]],
           "engine_rounds_per_sec": [r for r, _ in out["engine"]],
           "sync_busy_share": [b for _, b in out["sync"]],
           "engine_busy_share": [b for _, b in out["engine"]],
           "card": card}
    print(json.dumps(row))
    del fm, opt, sched, eng
    torch.cuda.empty_cache()
    return row


def checkpoint_resume(card, label, extra, num_clients):
    """6 rounds straight against 3 rounds, ``save_round_state``, a new
    FedModel / FedOptimizer / LambdaLR restored with ``load_run_state``,
    and 3 more: weights, server state, client rows and the download
    accounting bit-equal. Save and load ms, the file's size."""
    batches = [synthetic_batch(s) for s in range(6)]
    _, fm_a, opt_a, sched_a, one_a = build_round(extra, num_clients)
    for b in batches:
        one_a(b)
    args, fm_b, opt_b, sched_b, one_b = build_round(extra, num_clients)
    for b in batches[:3]:
        one_b(b)
    sampler = {"permuted": np.arange(64, dtype=np.int64),
               "cursor": np.zeros(num_clients, np.int64)}
    with tempfile.TemporaryDirectory() as tmp:
        args.checkpoint_path = tmp
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_round_state(args, 0, 3, sampler, fm_b, opt_b, sched_b,
                                (0.0, 0.0))
        save_ms = 1e3 * (time.perf_counter() - t0)
        size = os.path.getsize(path)
        del fm_b, opt_b, sched_b, one_b
        torch.cuda.empty_cache()
        _, fm_c, opt_c, sched_c, one_c = build_round(extra, num_clients)
        fm_c.ps_weights = fm_c.ps_weights + 1.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, mid = load_run_state(path, fm_c, opt_c, sched_c)
        torch.cuda.synchronize()
        load_ms = 1e3 * (time.perf_counter() - t0)
    assert mid["rounds_done"] == 3
    for b in batches[3:]:
        one_c(b)
    torch.cuda.synchronize()
    pairs = [("weights", fm_c.ps_weights, fm_a.ps_weights),
             ("server velocity", opt_c.server_state.velocity,
              opt_a.server_state.velocity),
             ("server error", opt_c.server_state.error,
              opt_a.server_state.error),
             ("prev_ps", fm_c._prev_ps, fm_a._prev_ps)]
    pairs += [(f"client {n}", a, b) for n, a, b in zip(
        ClientStates._fields, fm_c.client_states, fm_a.client_states)
        if a is not None or b is not None]
    for name, a, b in pairs:
        assert a is not None and b is not None and bit_equal(a, b), \
            f"{label} resume: {name} differs from the continuous run"
    assert torch.equal(fm_c._last_changed, fm_a._last_changed)
    assert np.array_equal(fm_c._client_part_round, fm_a._client_part_round)
    assert fm_c.rounds_dispatched == fm_a.rounds_dispatched == 6
    assert sched_c._step_count == sched_a._step_count == 6
    row = {"phase": "lifecycle", "resume": label, "save_ms": save_ms,
           "load_ms": load_ms, "file_bytes": size,
           "bit_equal": [n for n, _, _ in pairs]
           + ["last_changed", "client_part_round"], "card": card}
    print(json.dumps(row))
    del fm_a, opt_a, fm_c, opt_c
    torch.cuda.empty_cache()
    return row


def cli_resume(deterministic: bool) -> int:
    """``cv_train.main`` with ``--batchnorm`` on synthetic CIFAR10 (16
    clients, 8 a round), once through with ``--checkpoint_every_rounds
    2`` and once resumed with ``--resume auto`` from its round-2 run
    state; returns how many arrays of the two final ``ResNet9.npz``
    differ. With cuDNN pinned deterministic none may."""
    from commefficient_torch import cv_train

    cm = deterministic_cudnn() if deterministic else contextlib.nullcontext()
    with tempfile.TemporaryDirectory() as tmp, cm:
        os.environ["COMMEFFICIENT_SYNTHETIC_PER_CLASS"] = "16"
        argv = HEADLINE + [
            "--dataset_dir", os.path.join(tmp, "cifar10"), "--iid",
            "--num_clients", "16", "--num_epochs", "1", "--seed", "0",
            "--batchnorm", "--checkpoint"]
        full = cv_train.main(argv + [
            "--checkpoint_path", os.path.join(tmp, "full"),
            "--checkpoint_every_rounds", "2"])
        os.makedirs(os.path.join(tmp, "res"))
        shutil.copy(os.path.join(tmp, "full", "run_state_ep1_r2.npz"),
                    os.path.join(tmp, "res"))
        res = cv_train.main(argv + [
            "--checkpoint_path", os.path.join(tmp, "res"),
            "--resume", "auto"])
        with np.load(os.path.join(tmp, "full", "ResNet9.npz")) as a, \
                np.load(os.path.join(tmp, "res", "ResNet9.npz")) as b:
            assert sorted(a.files) == sorted(b.files)
            differ = sum(not np.array_equal(a[k], b[k]) for k in a.files)
            n = len(a.files)
    assert np.isfinite(full["train_loss"]) and np.isfinite(res["train_loss"])
    print(f"cv_train --batchnorm resume (cuDNN "
          f"{'deterministic' if deterministic else 'free'}): {differ} of "
          f"{n} final arrays differ from the continuous run")
    if deterministic:
        assert differ == 0, "cv_train resume not bit-identical"
    return differ


def phase_lifecycle(card: str) -> dict:
    """Phase 8: the run lifecycle at full width, with cuDNN pinned
    deterministic (``deterministic_cudnn``) where bits are compared.

    (a) the headline and the opt-in round through the pipelined engine
    (window 2, drain every 8) for 24 rounds: bit-equal to the synchronous
    loop, no stream synchronization in a non-drain submit (under
    ``set_sync_debug_mode("error")``) and no fetch, 2 / 1 / 8 launches a
    headline round; then rounds/sec and busy share, loop against engine,
    in PAIRS alternating pairs (data, no claim);
    (b) resume: 6 rounds straight against 3 + ``save_round_state`` + a
    new model restored by ``load_run_state`` + 3, bit-equal (the headline
    round, and the sketch-local round with its client tables);
    (c) ``--batchnorm``: d = 6,573,120, 10 headline rounds with finite
    losses and 2 / 1 / 8 launches a round, finite averaged running
    statistics, the device's time by kernel over 3 profiled rounds, one
    server step equal through kernels and plain versions;
    (d) ``cv_train --batchnorm`` resumed mid-epoch with ``--resume auto``:
    bit-identical to the continuous run with cuDNN deterministic, and the
    count of differing arrays with cuDNN free (data)."""
    out = {}
    os.environ[ttk.FUSED_DESCENT_ENV] = "1"
    with deterministic_cudnn():
        engine_identity("opt-in", OPT_IN, None)
    del os.environ[ttk.FUSED_DESCENT_ENV]
    with deterministic_cudnn():
        engine_identity("headline", [], HEADLINE_PER_ROUND)
    out["pairs"] = [engine_pairs(card, "headline", [])]
    os.environ[ttk.FUSED_DESCENT_ENV] = "1"
    out["pairs"].append(engine_pairs(card, "opt-in", OPT_IN))
    del os.environ[ttk.FUSED_DESCENT_ENV]

    with deterministic_cudnn():
        out["resume"] = [
            checkpoint_resume(card, "headline", [], 64),
            checkpoint_resume(card, "sketch-local",
                              ["--error_type", "local", "--local_momentum",
                               "0.9", "--virtual_momentum", "0"], 16)]

    args, fm, opt, sched, one_round = build_round(["--batchnorm"])
    assert fm.grad_size == 6_573_120, fm.grad_size
    batch = synthetic_batch()
    counts, rps = timed_rounds(one_round, batch, HEADLINE_PER_ROUND,
                               "batchnorm", n=BN_ROUNDS)
    stats = fm._model_state
    assert len(stats) == 16 and all(
        bool(torch.isfinite(v).all()) for v in stats.values()), \
        "batchnorm: non-finite running statistics"
    prof = profile_rounds(lambda: one_round(batch), n=3)
    check_server_step(fm, opt, synthetic_batch(1), "batchnorm")
    out["batchnorm"] = {"phase": "lifecycle", "round": "batchnorm",
                        "d": fm.grad_size, "rounds_per_sec": rps,
                        "rounds": BN_ROUNDS, "launches": counts,
                        "profiled_busy_ms_per_round":
                            prof["profiled_busy_ms_per_round"],
                        "profiled_wall_ms_per_round":
                            prof["profiled_wall_ms_per_round"],
                        "card": card}
    print(json.dumps(out["batchnorm"]))
    del fm, opt, sched
    torch.cuda.empty_cache()
    out["cli_resume_differing"] = {"free": cli_resume(False),
                                   "deterministic": cli_resume(True)}
    return out


# phase 9: GPT-2 on PersonaChat (BASELINE.md config 5), bench.py's round
GPT2_D = 124_444_417
GPT2_MODEL = {"vocab_size": 50_262, "n_positions": 1024}
GPT2_W, GPT2_B, GPT2_C, GPT2_T = 4, 2, 2, 256
GPT2_BASE = ["--mode", "sketch", "--error_type", "virtual",
             "--local_momentum", "0", "--virtual_momentum", "0.9",
             "--num_rows", "5", "--num_cols", "500000", "--k", "50000",
             "--num_blocks", "20", "--num_workers", str(GPT2_W),
             "--local_batch_size", str(GPT2_B),
             "--num_candidates", str(GPT2_C), "--max_seq_len", str(GPT2_T),
             "--valid_batch_size", "2", "--device", "cuda", "--seed", "0",
             "--no_telemetry"]
GPT2_TIMED_ROUNDS = 6
GPT2_LEGS = (("gpt2 f32", []), ("gpt2 bf16", ["--bf16"]),
             ("gpt2 opt-in", OPT_IN))


def gpt2_batch(seed: int = 0):
    """A seeded synthetic GPT-2 round (bench.py's): W clients x B examples
    x C candidates x T tokens of ids below 50,000."""
    rng = np.random.RandomState(seed)
    W, B, C, T = GPT2_W, GPT2_B, GPT2_C, GPT2_T
    return {
        "input_ids": rng.randint(0, 50000, (W, B, C, T)).astype(np.int64),
        "token_type_ids": rng.randint(0, 50000, (W, B, C, T)).astype(
            np.int64),
        "lm_labels": rng.randint(0, 50000, (W, B, C, T)).astype(np.int64),
        "mc_token_ids": rng.randint(0, T, (W, B, C)).astype(np.int64),
        "mc_labels": rng.randint(0, C, (W, B)).astype(np.int64),
        "mask": np.ones((W, B), np.float32),
        "client_ids": np.arange(W, dtype=np.int32),
        "worker_mask": np.ones(W, np.float32)}


def build_gpt2(extra, num_clients: int = 8):
    """FedModel / FedOptimizer / LambdaLR for the GPT-2 round plus the
    flags ``extra``; returns ``(args, fm, opt, sched, one_round)``."""
    args = parse_args(default_lr=4e-2, argv=GPT2_BASE + extra + [
        "--dataset_name", "PERSONA", "--num_clients", str(num_clients)])
    model = GPT2DoubleHeads(**GPT2_MODEL)
    train_loss, val_loss = make_gpt2_losses(
        model, compute_dtype=torch.bfloat16 if args.do_bf16 else None)
    fm = FedModel(model, train_loss, args, val_loss, num_clients=num_clients)
    assert fm.grad_size == GPT2_D, fm.grad_size
    opt = FedOptimizer(fm, args)
    schedule = PiecewiseLinear([0, 100], [args.lr_scale, 0.0])
    sched = LambdaLR(opt, lambda step: schedule(step))
    print(f"gpt2 d = {fm.grad_size:,}, sketch {fm.sketch.r} x "
          f"{fm.sketch.c_pad} (T = {fm.sketch.T}), k = {args.k}")

    def one_round(batch):
        sched.step()
        out = fm(batch)
        opt.step()
        return out

    return args, fm, opt, sched, one_round


def gpt2_leg(card: str, label: str, extra) -> dict:
    """One timed GPT-2 leg: 2 warm-up and GPT2_TIMED_ROUNDS rounds
    (launches checked exactly), tokens/sec, the phase split over 3
    rounds, the device's busy share and time by kernel over 3 profiled
    rounds, the peak memory of the timed rounds."""
    opt_in = extra is OPT_IN
    if opt_in:
        os.environ[ttk.FUSED_DESCENT_ENV] = "1"
    args, fm, opt, sched, one_round = build_gpt2(list(extra))
    if opt_in:
        segs, groups = fm.steps.stream_segments, fm.steps.stream_groups
        print(f"{label} plan: {len(segs)} leaves in {len(groups)} groups "
              f"(budget {tsk.coalesce_vmem_budget(fm.sketch):,} B), "
              f"largest group {max(g.t_b - g.t_a for g in groups)} chunks")
        per_round = opt_in_per_round(fm, args, GPT2_B)
    else:
        per_round = HEADLINE_PER_ROUND
    batch = gpt2_batch()
    torch.cuda.reset_peak_memory_stats()
    counts, rps = timed_rounds(one_round, batch, per_round, label,
                               n=GPT2_TIMED_ROUNDS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tokens = GPT2_W * GPT2_B * GPT2_C * GPT2_T
    split = phase_split(fm, opt, sched, batch, label, n=3)
    prof = profile_rounds(lambda: one_round(batch), n=3)
    row = {"phase": "gpt2", "leg": label, "d": fm.grad_size,
           "tokens_per_round": tokens, "tokens_per_sec": rps * tokens,
           "rounds_per_sec": rps, "rounds": GPT2_TIMED_ROUNDS,
           "launches_per_round": per_round, **split,
           "profiled_busy_share": (prof["profiled_busy_ms_per_round"]
                                   / prof["profiled_wall_ms_per_round"]),
           **prof, "peak_memory_GB": peak_gb, "card": card}
    print(json.dumps(row))
    if not opt_in and not args.do_bf16:
        check_server_step(fm, opt, gpt2_batch(1), label)
    os.environ.pop(ttk.FUSED_DESCENT_ENV, None)
    row["counts"] = counts
    del fm, opt, sched
    torch.cuda.empty_cache()
    return row


def gpt2_cli() -> dict:
    """``gpt2_train.train`` for one epoch at full width on the seeded
    synthetic PersonaChat (8 personalities) in a temporary directory:
    finite val NLL and perplexity, the headline kernels launched and the
    opt-in ones not, and ``model.npz`` written."""
    from commefficient_torch import gpt2_train

    with tempfile.TemporaryDirectory() as tmp:
        os.environ["COMMEFFICIENT_SYNTHETIC_CLIENTS"] = "8"
        os.environ["COMMEFFICIENT_RUN_DIR"] = os.path.join(tmp, "run")
        kernels.reset_launch_counts()
        try:
            stats = gpt2_train.train(GPT2_BASE + [
                "--dataset_dir", os.path.join(tmp, "persona"),
                "--num_epochs", "1"])
        finally:
            os.environ.pop("COMMEFFICIENT_SYNTHETIC_CLIENTS")
            os.environ.pop("COMMEFFICIENT_RUN_DIR")
        counts = kernels.launch_counts()
        saved = os.path.exists(os.path.join(tmp, "run", "model.npz"))
    assert saved, "gpt2_train wrote no model.npz"
    assert np.isfinite(stats["val_nll"]) and np.isfinite(stats["val_ppl"]), \
        stats
    assert all((counts[k] > 0) == (k in HEADLINE_KERNELS) for k in counts), \
        counts
    row = {"phase": "gpt2", "cli": "gpt2_train", **{
        k: float(v) for k, v in stats.items()}, "launches": counts}
    print(json.dumps(row))
    return row


def phase_gpt2(card: str) -> dict:
    """Phase 9: GPT-2 on PersonaChat at full width (d = 124,444,417,
    vocab 50,262, 12 x 768, 12 heads), bench.py's round (4 clients x 2
    examples x 2 candidates x 256 tokens, 5 x 500,000 sketch, 20 blocks,
    k = 50,000, virtual momentum 0.9).

    (a) all six kernels against their plain versions at this geometry
    (Tn = 249 chunks of 500,096; the count pass and the descent over
    124,523,904 patterns, k = 50,000), timed;
    (b) three timed legs through FedModel: the headline round in float32
    and under ``--bf16``, and the opt-in round in float32, launches a
    round exactly 2 / 1 / 8 and the plan's count;
    (c) one server step through kernels and plain versions (in (b));
    (d) one ``gpt2_train`` epoch."""
    out = {"kernels": check_kernels(card, GPT2_D, 500_000, 5, 0, 10, "gpt2",
                                    True, k=50_000)}
    for name, row in out["kernels"].items():
        print(json.dumps({"phase": "gpt2 kernels", "geometry": "gpt2",
                          "name": name, **row}))
    out["legs"] = {label: gpt2_leg(card, label, extra)
                   for label, extra in GPT2_LEGS}
    f32, bf16 = out["legs"]["gpt2 f32"], out["legs"]["gpt2 bf16"]
    opt_in = out["legs"]["gpt2 opt-in"]
    print(f"gpt2 tokens/sec: f32 {f32['tokens_per_sec']:.1f}, bf16 "
          f"{bf16['tokens_per_sec']:.1f}, opt-in "
          f"{opt_in['tokens_per_sec']:.1f} ({card}, same call)")
    out["cli"] = gpt2_cli()
    return out


# phase 10: the other CV models. The FEMNIST ResNet101-LN round (the
# recipe of scripts/femnist_ablation.py: 8 clients x 16 images) and the
# ImageNet FixupResNet50 round of scripts/imagenet.sh (7 clients x 64
# images at 224 x 224, uncompressed, Fixup's LR groups)
FEMNIST_D = 42_620_926
FEMNIST_TC = (86, 500_096)  # chunks and their padded width
FEMNIST_W, FEMNIST_B = 8, 16
FEMNIST_BASE = ["--mode", "sketch", "--error_type", "virtual",
                "--local_momentum", "0", "--virtual_momentum", "0.9",
                "--num_rows", "5", "--num_cols", "500000", "--k", "50000",
                "--num_workers", str(FEMNIST_W),
                "--local_batch_size", str(FEMNIST_B),
                "--dataset_name", "EMNIST", "--model", "ResNet101LN",
                "--device", "cuda", "--seed", "0", "--no_telemetry"]
FEMNIST_ROUNDS = 24
IMAGENET_D = 25_504_030
IMAGENET_W, IMAGENET_B = 7, 64
IMAGENET_BASE = ["--mode", "uncompressed", "--error_type", "none",
                 "--local_momentum", "0", "--virtual_momentum", "0.9",
                 "--weight_decay", "1e-4", "--num_workers", str(IMAGENET_W),
                 "--local_batch_size", str(IMAGENET_B),
                 "--microbatch_size", "16", "--dataset_name", "ImageNet",
                 "--model", "FixupResNet50", "--iid",
                 "--num_clients", str(IMAGENET_W), "--device", "cuda",
                 "--seed", "0", "--no_telemetry"]
IMAGENET_TIMED_ROUNDS = 3


@contextlib.contextmanager
def env_vars(**values):
    """Environment variables set for the block, restored after it."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def draw_batches(loader, n: int) -> list:
    """``n`` train batches from ``loader``, over as many epochs as that
    takes."""
    out = []
    while len(out) < n:
        out.extend(b for _, b in zip(range(n - len(out)), loader))
    return out


def femnist_data(tmp: str):
    """The FEMNIST train set through ``FedEMNIST`` (its seeded synthetic
    LEAF fallback: 100 writers, about 40 images each), the FEMNIST
    transforms and ``FedLoader``, 8 clients x 16 images a round."""
    from commefficient_torch.data_utils import FedEMNIST, FedLoader
    from commefficient_torch.data_utils import transforms

    np.random.seed(0)
    ds = FedEMNIST(os.path.join(tmp, "femnist"), "EMNIST",
                   transforms.femnist_train_transforms, False, None,
                   train=True, download=True)
    return FedLoader(ds, FEMNIST_W, FEMNIST_B)


def build_cv(base, extra, num_clients: int):
    """FedModel / FedOptimizer / LambdaLR for a phase-10 round, the model
    and the LR groups as ``cv_train`` builds them; returns ``(args, fm,
    opt, sched, one_round)``."""
    from commefficient_torch import cv_train

    args = parse_args(argv=base + extra)
    model = cv_train.build_model_and_config(args)
    cv_train.check_trainable(model)
    train_loss, val_loss = make_cv_losses(model)
    fm = FedModel(model, train_loss, args, val_loss, num_clients=num_clients)
    opt = FedOptimizer(fm, args, param_groups=cv_train.build_param_groups(
        args, fm.param_layout))
    schedule = PiecewiseLinear([0, 100], [0.1, 0.0])
    sched = LambdaLR(opt, lambda step: schedule(step))

    def one_round(batch):
        sched.step()
        out = fm(batch)
        opt.step()
        return out

    return args, fm, opt, sched, one_round


def femnist_leg(card: str, label: str, extra, batches) -> dict:
    """One FEMNIST ResNet101-LN leg: 2 warm-up and 20 timed rounds over the
    pre-drawn batches (launches checked exactly), rounds/sec and
    images/sec, the phase split, the busy share and device time by kernel
    over 5 profiled rounds, the peak memory."""
    opt_in = extra is OPT_IN
    with env_vars(**({ttk.FUSED_DESCENT_ENV: "1"} if opt_in else {})):
        args, fm, opt, sched, one_round = build_cv(
            FEMNIST_BASE, list(extra), num_clients=100)
        assert fm.grad_size == FEMNIST_D, fm.grad_size
        assert (fm.sketch.T, fm.sketch.c_pad) == FEMNIST_TC
        if opt_in:
            segs, groups = fm.steps.stream_segments, fm.steps.stream_groups
            print(f"{label} plan: {len(segs)} leaves in {len(groups)} "
                  f"groups (budget {tsk.coalesce_vmem_budget(fm.sketch):,} "
                  f"B), largest group "
                  f"{max(g.t_b - g.t_a for g in groups)} chunks")
            per_round = opt_in_per_round(fm, args, FEMNIST_B)
        else:
            per_round = HEADLINE_PER_ROUND
        cycle = itertools.cycle(batches)
        torch.cuda.reset_peak_memory_stats()
        counts, rps = timed_rounds(lambda _b: one_round(next(cycle)), None,
                                   per_round, label)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        split = phase_split(fm, opt, sched, batches[0], label)
        prof = profile_rounds(lambda: one_round(next(cycle)))
        images = FEMNIST_W * FEMNIST_B
        row = {"phase": "femnist", "leg": label, "d": fm.grad_size,
               "T": fm.sketch.T, "images_per_round": images,
               "rounds_per_sec": rps, "images_per_sec": rps * images,
               "rounds": TIMED_ROUNDS, "launches_per_round": per_round,
               **split, "profiled_busy_share": (
                   prof["profiled_busy_ms_per_round"]
                   / prof["profiled_wall_ms_per_round"]),
               **prof, "peak_memory_GB": peak_gb, "card": card}
        if opt_in:
            row["groups"] = len(fm.steps.stream_groups)
        print(json.dumps(row))
        check_server_step(fm, opt, batches[1], label)
    row["counts"] = counts
    del fm, opt, sched
    torch.cuda.empty_cache()
    return row


def loader_checks(card: str, loader) -> dict:
    """The data plane: batches/sec of the FEMNIST train loader, plain and
    under ``PrefetchLoader``; the native ``image_batch`` (a CIFAR round,
    8 x 8 images with pad, crop and flip) against its numpy version, and
    ``resized_crop`` in the fused ImageNet stacks (16 ImageNet-sized
    images, train and val) against the per-op numpy stacks, within the
    JAX package's tolerances (1e-5 and 2e-4), with the largest error and
    the ms of each."""
    from commefficient_torch import native
    from commefficient_torch.data_utils import PrefetchLoader
    from commefficient_torch.data_utils import transforms

    out = {}
    for name, wrap in (("plain", lambda x: x),
                       ("prefetch", PrefetchLoader)):
        n = 12
        t0 = time.perf_counter()
        draw_batches(wrap(loader), n)
        out[f"femnist_loader_{name}_batches_per_sec"] = \
            n / (time.perf_counter() - t0)
    rng = np.random.RandomState(0)
    src = rng.randint(0, 256, (640, 32, 32, 3)).astype(np.uint8)
    idx = rng.randint(0, 640, 64).astype(np.int64)
    idx[5] = -1
    ch, cw = (rng.randint(0, 9, 64).astype(np.int32) for _ in range(2))
    fl = rng.randint(0, 2, 64).astype(np.uint8)
    args = (src, idx, ch, cw, fl, 4, 32, transforms.cifar10_mean,
            transforms.cifar10_std)
    t0 = time.perf_counter()
    got = native.image_batch(*args)
    t1 = time.perf_counter()
    want = native._image_batch_np(*args)
    t2 = time.perf_counter()
    err = float(np.abs(got - want).max())
    assert err <= 1e-5, f"image_batch: max error {err}"
    out.update(image_batch_max_err=err, image_batch_ms=1e3 * (t1 - t0),
               image_batch_numpy_ms=1e3 * (t2 - t1))
    # the ImageNet stacks: fused (one native call an image) against the
    # per-op numpy stacks, on 16 ImageNet-sized images, both drawing the
    # same np.random sequence
    errs, ms, np_ms = [], 0.0, 0.0
    for i in range(16):
        img = rng.randint(0, 256, (300 + 13 * i, 500 - 11 * i, 3)).astype(
            np.uint8)
        fused, plain = ((transforms.imagenet_train_transforms,
                         transforms.imagenet_train_transforms_py) if i % 2
                        else (transforms.imagenet_val_transforms,
                              transforms.imagenet_val_transforms_py))
        np.random.seed(i)
        t0 = time.perf_counter()
        got = fused(img)
        t1 = time.perf_counter()
        np.random.seed(i)
        want = plain(img)
        ms += t1 - t0
        np_ms += time.perf_counter() - t1
        errs.append(float(np.abs(got - want).max()))
    assert max(errs) <= 2e-4, f"resized_crop: max error {max(errs)}"
    out.update(resized_crop_max_err=max(errs),
               resized_crop_ms=1e3 * ms / 16,
               resized_crop_numpy_ms=1e3 * np_ms / 16)
    print(json.dumps({"phase": "femnist loader", **out, "card": card}))
    return out


def imagenet_leg(card: str, tmp: str) -> dict:
    """The ImageNet FixupResNet50 round of scripts/imagenet.sh at full
    width: batches through ``FedImageNet`` (its synthetic ``.npy`` tree),
    the fused resized-crop transforms (the native plane) and
    ``FedLoader``; Fixup's three LR groups read back from
    ``FedOptimizer``; 2 warm-up and a few timed rounds (no port kernel
    launches); one server step equal to ``ps - (g + 0.9 v) * lr_vec``
    computed here from the LR vector."""
    from commefficient_torch.data_utils import FedImageNet, FedLoader
    from commefficient_torch.data_utils import transforms

    with env_vars(COMMEFFICIENT_SYNTHETIC_CLIENTS=16,
                  COMMEFFICIENT_SYNTHETIC_PER_CLASS=64):
        np.random.seed(0)
        ds = FedImageNet(os.path.join(tmp, "imagenet"), "ImageNet",
                         transforms.imagenet_train_transforms, True,
                         IMAGENET_W, train=True, download=True)
    t0 = time.perf_counter()
    batches = draw_batches(FedLoader(ds, IMAGENET_W, IMAGENET_B), 3)
    load_s = (time.perf_counter() - t0) / 3
    assert batches[0]["inputs"].shape == (IMAGENET_W, IMAGENET_B, 224, 224,
                                          3)
    args, fm, opt, sched, one_round = build_cv(IMAGENET_BASE, [],
                                               IMAGENET_W)
    assert fm.grad_size == IMAGENET_D, fm.grad_size
    groups = opt.param_groups
    assert [b for _, b in groups] == [0.1, 0.1, 1.0], groups
    lrs = sched.get_last_lr()
    vec = opt.get_lr()
    for (mask, base), lr in zip(groups, lrs):
        # one value a group: the float32 base LR times the factor
        got = torch.unique(vec[torch.from_numpy(mask).to(fm.device)])
        assert got.numel() == 1 and abs(float(got) - lr) <= 1e-6 * lr, \
            (base, lr, got)
    sizes = [int(m.sum()) for m, _ in groups]
    print(f"imagenet LR groups (bias, scale, other): {sizes} coordinates, "
          f"LRs {lrs}")
    cycle = itertools.cycle(batches)
    torch.cuda.reset_peak_memory_stats()
    counts, rps = timed_rounds(lambda _b: one_round(next(cycle)), None, {},
                               "imagenet", n=IMAGENET_TIMED_ROUNDS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    split = phase_split(fm, opt, sched, batches[0], "imagenet", n=2)
    prof = profile_rounds(lambda: one_round(next(cycle)), n=2)
    # one server step against the rule computed from the LR vector
    sched.step()
    fm.begin_round(batches[1])
    g = fm._round_ctx.gradient
    ps, vel, lr = fm.ps_weights, opt.server_state.velocity, opt.get_lr()
    want = ps - (g + 0.9 * vel) * lr
    opt.step()
    torch.cuda.synchronize()
    assert torch.equal(fm.ps_weights, want), "imagenet server step"
    moved = [int(((fm.ps_weights != ps) & torch.from_numpy(m).to(
        fm.device)).sum()) for m, _ in groups]
    print(f"imagenet server step equal to ps - (g + 0.9 v) * lr_vec; "
          f"coordinates moved by group: {moved}")
    images = IMAGENET_W * IMAGENET_B
    row = {"phase": "imagenet", "d": fm.grad_size, "images_per_round":
           images, "rounds_per_sec": rps, "images_per_sec": rps * images,
           "rounds": IMAGENET_TIMED_ROUNDS, "microbatch": 16,
           "lr_groups": dict(zip(("bias", "scale", "other"), lrs)),
           "loader_s_per_batch": load_s, **split,
           "profiled_busy_share": (prof["profiled_busy_ms_per_round"]
                                   / prof["profiled_wall_ms_per_round"]),
           **prof, "peak_memory_GB": peak_gb, "card": card}
    print(json.dumps(row))
    del fm, opt, sched
    torch.cuda.empty_cache()
    return row


def run_cv_train(argv, env) -> dict:
    """``python -m commefficient_torch.cv_train`` in a child process: its
    last table row's train and test loss (finite), and the finetune
    line's count of loaded leaves where it prints one."""
    proc = subprocess.run(
        [sys.executable, "-m", "commefficient_torch.cv_train", *argv],
        env={**os.environ, **{k: str(v) for k, v in env.items()}},
        capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        print(proc.stdout[-3000:], proc.stderr[-6000:], sep="\n")
        raise RuntimeError(f"cv_train exited {proc.returncode}")
    lines = proc.stdout.splitlines()
    head = max(i for i, ln in enumerate(lines) if "train_loss" in ln)
    rows = list(itertools.takewhile(lambda ln: not ln.startswith("Total"),
                                    lines[head + 1:]))
    cells = rows[-1].split()
    out = {"train_loss": float(cells[3]), "test_loss": float(cells[5])}
    assert np.isfinite(out["train_loss"]) and np.isfinite(
        out["test_loss"]), out
    for ln in lines:
        if ln.startswith("finetune: loaded"):
            print(ln)
            out["loaded"] = int(ln.split()[2])
    return out


def cv_train_runs(tmp: str) -> dict:
    """``cv_train`` end to end: FEMNIST ResNet101-LN at full width for a
    few rounds (16 writers of 16 images, 2 epochs of 2 rounds, a prefetch
    thread, the FEMNIST recipe's peak LR 0.1), a CIFAR100 ResNet9 run that writes its checkpoint, and a
    ``--finetune`` CIFAR10 run from it (every leaf but the reshaped head
    loads)."""
    out = {"emnist": run_cv_train(FEMNIST_BASE + [
        "--dataset_dir", os.path.join(tmp, "femnist_cli"), "--num_epochs",
        "2", "--train_dataloader_workers", "1", "--valid_batch_size", "16",
        "--lr_scale", "0.1"],
        {"COMMEFFICIENT_SYNTHETIC_CLIENTS": 16,
         "COMMEFFICIENT_SYNTHETIC_SAMPLES": 16})}
    cifar = HEADLINE + ["--model", "ResNet9", "--iid", "--num_clients",
                        "16", "--num_epochs", "1", "--seed", "0"]
    ck = os.path.join(tmp, "ck")
    env = {"COMMEFFICIENT_SYNTHETIC_PER_CLASS": 8}
    out["cifar100"] = run_cv_train(cifar + [
        "--dataset_name", "CIFAR100", "--dataset_dir",
        os.path.join(tmp, "c100"), "--checkpoint", "--checkpoint_path", ck],
        env)
    assert os.path.exists(os.path.join(ck, "ResNet9.npz"))
    out["finetune"] = run_cv_train(cifar + [
        "--dataset_name", "CIFAR10", "--dataset_dir",
        os.path.join(tmp, "c10"), "--finetune", "--finetuned_from",
        "CIFAR100", "--finetune_path", ck], env)
    assert out["finetune"]["loaded"] == 8, out["finetune"]
    print(json.dumps({"phase": "cv_train", **out}))
    return out


def phase_cv_models(card: str) -> dict:
    """Phase 10: the other CV models.

    (a) all six kernels against their plain versions at the FEMNIST
    ResNet101-LN geometry (d = 42,620,926, Tn = 86 chunks of 500,096, the
    count pass and the descent over 43,008,256 patterns, k = 50,000),
    timed;
    (b) the FEMNIST ResNet101-LN round at full width on batches drawn
    through ``FedEMNIST`` / the FEMNIST transforms / ``FedLoader``: the
    headline (kernels 1, 3, 5 at 2 / 1 / 8 a round) and the opt-in leg
    (2, 3, 4, 6; the plan's count), each timed, split, profiled, with the
    peak memory and a server step through kernels and plain versions;
    (c) the loader and the native data plane (``loader_checks``);
    (d) the ImageNet FixupResNet50 round (``imagenet_leg``);
    (e) ``cv_train`` end to end (``cv_train_runs``)."""
    out = {"kernels": check_kernels(card, FEMNIST_D, 500_000, 5, 0, 12,
                                    "femnist", True, k=50_000)}
    for name, row in out["kernels"].items():
        print(json.dumps({"phase": "femnist kernels", "geometry": "femnist",
                          "name": name, **row}))
    with tempfile.TemporaryDirectory() as tmp:
        loader = femnist_data(tmp)
        batches = draw_batches(loader, 6)
        assert batches[0]["inputs"].shape == (FEMNIST_W, FEMNIST_B, 28, 28,
                                              1)
        out["legs"] = {label: femnist_leg(card, label, extra, batches)
                       for label, extra in (("femnist", []),
                                            ("femnist opt-in", OPT_IN))}
        out["loader"] = loader_checks(card, loader)
        out["imagenet"] = imagenet_leg(card, tmp)
        out["cli"] = cv_train_runs(tmp)
    head, opt_in = out["legs"]["femnist"], out["legs"]["femnist opt-in"]
    print(f"femnist images/sec: headline {head['images_per_sec']:.1f}, "
          f"opt-in {opt_in['images_per_sec']:.1f}; imagenet "
          f"{out['imagenet']['images_per_sec']:.1f} ({card}, same call)")
    return out


def kernel_times(card: str, only=()) -> int:
    """``--kernel-times``: the accumulate pair, the query, the count pass,
    the fused epilogue and the descent alone, at the headline geometry, one
    JSON line per timing, tagged with the checkout; only the rows named in
    ``only``, if it names any."""
    d, c, r_max, k = 6_568_640, 500_000, 5, 50_000
    tree = os.path.dirname(os.path.dirname(os.path.abspath(kernels.__file__)))
    kernels.library()
    dev = torch.device("cuda")
    cs = tsk.make_sketch(d, c, r_max, seed=0, device=dev)
    gen = torch.Generator().manual_seed(0)
    plane = cs.chunk_layout.chunk(torch.randn(d, generator=gen)).to(dev)
    table = torch.randn((r_max, cs.sublanes, 128), generator=gen).to(dev)
    est = cs.chunk_layout.chunk(torch.randn(d, generator=gen)).to(dev)
    bits = est.reshape(-1).view(torch.int32)
    mags = bits & 0x7FFFFFFF

    def emit(name, **times):
        if not only or name in only:
            print(json.dumps({"tree": tree, "card": card, "name": name,
                              **{k: v() if callable(v) else v
                                 for k, v in times.items()}}))

    for r in (1, r_max):
        for Tn in (1, 3, cs.T):
            v3 = plane[:Tn].contiguous()
            q = cs.shift_q[:r, :Tn].contiguous()
            w = cs.shift_w[:r, :Tn].contiguous()
            keys = cs.sign_keys[:r].contiguous()
            tbl = table[:r].contiguous()
            emit("sketch_accumulate", r=r, Tn=Tn, ms=lambda: time_ms(
                lambda: kernels.sketch_accumulate(v3, q, w, keys, 0)))
            emit("sketch_accumulate_into", r=r, Tn=Tn, ms=lambda: time_ms(
                lambda: kernels.sketch_accumulate_into(tbl, v3, q, w, keys,
                                                       0)))

            def query():
                return kernels.sketch_estimates(tbl, q, w, keys, 0)

            emit("sketch_estimates", r=r, Tn=Tn, ms=lambda: time_ms(query),
                 warm_ms=lambda: time_ms(query, flush=False))
    # the round's query with its tail mask: one launch, or the query and
    # mask_tail's three operations
    emit("estimates_chunks", r=r_max, Tn=cs.T,
         ms=lambda: time_ms(lambda: tsk.estimates_chunks(cs, table)),
         warm_ms=lambda: time_ms(lambda: tsk.estimates_chunks(cs, table),
                                 flush=False))
    n = bits.numel()
    p = ttk._descent_plain(bits, k)
    # the descent's first and last passes (prefix 0 and p's top 7
    # nibbles), flushed and not (the patterns left in L2 as in the round)
    for shift, prefix in ((28, torch.zeros_like(p)), (0, p & ~15)):
        ts = ttk._pass_thresholds(prefix, shift)
        emit("topk_count_ge", n=n, shift=shift, ms=lambda: time_ms(
            lambda: kernels.topk_count_ge(bits, ts)), warm_ms=lambda: time_ms(
            lambda: kernels.topk_count_ge(bits, ts), flush=False))

    def epilogue():
        return kernels.fused_epilogue(est, p, cs.shift_q, cs.shift_w,
                                      cs.sign_keys, 0)

    emit("fused_epilogue", r=r_max, Tn=cs.T, k=k,
         ms=lambda: time_ms(epilogue),
         warm_ms=lambda: time_ms(epilogue, flush=False))
    emit("topk_descent", n=n, k=k,
         ms=lambda: time_ms(lambda: kernels.topk_descent(bits, k)))
    emit("torch.topk", n=n, k=k,
         ms=lambda: time_ms(lambda: torch.topk(mags, k, sorted=False)))
    emit("torch.kthvalue", n=n, k=k, ms=lambda: time_ms(
        lambda: torch.kthvalue(mags, n - k + 1), reps=5))
    return 0


# --------------------------------------------------------------------------
# phase 11: the multi-GPU data plane and HF GPT-2 weights
# --------------------------------------------------------------------------

SHARD_NS = (2, 4, 8)
SHARD_GEOMETRIES = (("resnet9", 6_568_640), ("gpt2", GPT2_D))
# a sharded headline round, per rank: the client table and the partial
# re-sketch, the query over this rank's chunks, 8 exchanged count passes;
# under --fused_epilogue the epilogue makes the partial re-sketch
SHARDED_PER_ROUND = HEADLINE_PER_ROUND
SHARDED_FUSED_PER_ROUND = {"sketch_accumulate": 1, "sketch_estimates": 1,
                           "topk_count_ge": 8, "fused_epilogue": 1}


def sharded_kernels(card: str, label: str, d: int, seed: int) -> dict:
    """Step 1: each rank's query, count passes, partial re-sketch and
    fused epilogue at ``t0 = rank * ceil(T / n)`` for n in SHARD_NS at
    this geometry (5 x 500,000, k = 50,000), padded tail included: each
    launch equal to its plain version; the ranks' estimates concatenated
    equal to the unsharded query (==, the zero-median sign free), their
    counts summed equal to the unsharded counts, their partial tables
    summed with the unsharded table's ``== 0`` pattern and its values to
    float32 order (``rtol=1e-5``, ``atol=1e-5 * max|table|``). Times
    (CUDA events, flushed) of rank 1's launches at each n."""
    dev = torch.device("cuda")
    cs = tsk.make_sketch(d, 500_000, 5, seed=seed, device=dev)
    T, S, r = cs.T, cs.sublanes, cs.r
    gen = torch.Generator().manual_seed(seed)
    table = torch.randn(cs.table_shape, generator=gen).to(dev)
    table3 = table.view(r, S, 128)
    keys = cs.sign_keys
    k = 50_000
    est_full = tsk.estimates_chunks(cs, table)
    bits_full = est_full.view(torch.int32).reshape(-1)
    passes, p = [], torch.zeros((), dtype=torch.int32, device=dev)
    for shift in range(28, -1, -4):
        ts = ttk._pass_thresholds(p, shift)
        counts = ttk.topk_count_ge(bits_full, ts)
        passes.append((ts, counts))
        p = p + ((counts >= k).sum().to(torch.int32) << shift)
    assert torch.equal(p, ttk.resolve_threshold(est_full, k))
    upd_full = ttk._apply_threshold(bits_full.view(est_full.shape), est_full,
                                    p)
    tbl_full = tsk.sketch_chunks(cs, upd_full)
    errs = {"sketch_estimates": 0.0, "topk_count_ge": 0.0,
            "sketch_accumulate": 0.0, "fused_epilogue": 0.0}
    times = {}
    for n in SHARD_NS:
        Tn = -(-T // n)
        ests, parts = [], []
        sums = [torch.zeros(16, dtype=torch.int64, device=dev)
                for _ in passes]
        for rank in range(n):
            t0 = rank * Tn
            est = tsk.estimates_chunks_local(cs, table, t0, Tn)
            iq, iw = tsk._shift_cols(cs.inv_q, cs.inv_w, t0, Tn)
            est_p = mask_past(tsk._sketch_estimates_plain(table3, iq, iw,
                                                          keys, t0), t0, d)
            assert bool((est == est_p).all()), \
                f"{label} n={n} rank {rank}: query != plain"
            bits = est.view(torch.int32).reshape(-1)
            for j, (ts, _) in enumerate(passes):
                got = ttk.topk_count_ge(bits, ts)
                want = ttk._count_ge_plain(bits, ts)
                assert torch.equal(got, want), \
                    f"{label} n={n} rank {rank}: count pass {j} != plain"
                sums[j] += got.to(torch.int64)
            q, w = tsk._shift_cols(cs.shift_q, cs.shift_w, t0, Tn)
            upd = ttk._apply_threshold(bits.view(est.shape), est, p)
            part = kernels.sketch_accumulate(upd, q, w, keys, t0)
            part_p = tsk._sketch_accumulate_plain(upd, q, w, keys, t0)
            assert bit_equal(part, part_p), \
                f"{label} n={n} rank {rank}: partial re-sketch != plain"
            fu, ft = kernels.fused_epilogue(est, p, q, w, keys, t0)
            fu_p, ft_p = tsk._fused_epilogue_plain(est, p, q, w, keys, t0)
            assert bit_equal(fu, fu_p) and bit_equal(ft, ft_p), \
                f"{label} n={n} rank {rank}: fused epilogue != plain"
            assert bit_equal(fu, upd) and bit_equal(ft, part), \
                f"{label} n={n} rank {rank}: epilogue != composed pair"
            if t0 > 0:
                for name, a, b in (("sketch_estimates", est, est_p),
                                   ("sketch_accumulate", part, part_p),
                                   ("fused_epilogue", ft, ft_p)):
                    errs[name] = max(errs[name], max_abs_err(a, b))
            if rank == 1:
                times[n] = {
                    "Tn": Tn, "t0": t0,
                    "sketch_estimates": time_ms(
                        lambda: kernels.sketch_estimates(table3, q, w, keys,
                                                         t0, d)),
                    "topk_count_ge": time_ms(
                        lambda: ttk.topk_count_ge(bits, passes[-1][0])),
                    "sketch_accumulate": time_ms(
                        lambda: kernels.sketch_accumulate(upd, q, w, keys,
                                                          t0)),
                    "fused_epilogue": time_ms(
                        lambda: kernels.fused_epilogue(est, p, q, w, keys,
                                                       t0))}
            ests.append(est)
            parts.append(part.view(r, -1))
        cat = torch.cat(ests)
        assert bool((cat[:T] == est_full).all()) and not cat[T:].any(), \
            f"{label} n={n}: the ranks' estimates != the unsharded query"
        for j, (_, want) in enumerate(passes):
            assert torch.equal(sums[j], want.to(torch.int64)), \
                f"{label} n={n}: summed counts of pass {j} != unsharded"
        summed = torch.stack(parts).sum(0)
        assert torch.equal(summed == 0, tbl_full == 0), \
            f"{label} n={n}: the partials' zero pattern != the table's"
        scale = float(tbl_full.abs().max())
        assert torch.allclose(summed, tbl_full, rtol=1e-5,
                              atol=1e-5 * scale), \
            f"{label} n={n}: the summed partials != the table"
        print(f"sharded kernels {label} n={n} (T = {T}, Tn = {Tn}, "
              f"{n * Tn - T} padded chunks): exact; rank 1 ms "
              + json.dumps({kk: round(v, 5) for kk, v in times[n].items()
                            if kk not in ("Tn", "t0")}))
    del est_full, upd_full, ests, parts
    torch.cuda.empty_cache()
    return {"T": T, "max_abs_err": errs, "rank1_ms": times, "card": card}


def host_ops(one_round, n: int = 5, top: int = 12) -> dict:
    """The host side of ``n`` rounds under ``torch.profiler``: the CPU
    operators by self time, busiest first, per round, and their total."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(n):
            one_round()
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                  reverse=True)
    return {"self_cpu_ms_per_round": sum(e.self_cpu_time_total
                                         for e in rows) / n / 1e3,
            "top": [(e.key[:60], round(e.self_cpu_time_total / n / 1e3, 4),
                     e.count / n) for e in rows[:top]]}


def _build_group_round(extra, group, num_clients: int = 64):
    """``build_round`` with the FedModel on ``group``."""
    args = parse_args(argv=HEADLINE + extra + [
        "--num_clients", str(num_clients), "--seed", "0"])
    model = ResNet9()
    train_loss, val_loss = make_cv_losses(model)
    fm = FedModel(model, train_loss, args, val_loss, num_clients=num_clients,
                  group=group)
    opt = FedOptimizer(fm, args)
    schedule = PiecewiseLinear([0, args.pivot_epoch, args.num_epochs],
                               [0, 0.4, 0])
    sched = LambdaLR(opt, lambda step: schedule(step / 50))

    def one_round(batch):
        sched.step()
        out = fm(batch)
        opt.step()
        return out

    return args, fm, opt, sched, one_round


def _weights(fm) -> torch.Tensor:
    return fm.layout.unchunk(fm.ps_weights).detach().clone()


def ef_identity(fm, opt, group, batch, label: str) -> dict:
    """The error-feedback identity of the quantized legs at full width:
    the round's own table through the table leg's ``quantized_psum`` and
    an update-sized plane through the downlink's ``quantized_all_gather``,
    each with the carry it holds and the round's generators: transmitted
    plus new carry equals contribution plus old carry (JAX's tests' bound,
    here ``atol = 1e-6 * max|contribution|``). On a group of one rank this
    is a smoke check of the quantizers on the card at full width, not a
    test of the collective: the carry is defined as the contribution less
    its dequantized value, and an all-to-all of one rank is the identity.
    The cross-rank identity is held by the multi-process CPU tests."""
    from commefficient_torch.ops import collectives as coll

    plan = fm.round_config.collective_plan
    cs = fm.sketch
    fm.begin_round(batch)
    table = fm._round_ctx.gradient
    st = opt.server_state
    sr = fm.sr_generators(fm.rounds_dispatched - 1)
    out = {}
    if plan.table != "float32":
        got, new = coll.quantized_psum(table, group, sr["up"],
                                       residual=st.qres, block=cs.c_pad,
                                       dtype=plan.table)
        contrib = table + st.qres
        scale = float(contrib.abs().max())
        err = float((got + new - contrib).abs().max())
        assert err <= 1e-6 * scale, f"{label}: table leg identity {err}"
        out["table_identity_max_err"] = err
    if plan.downlink != "float32":
        Tn = -(-cs.T // group.size)
        upd = tsk.unsketch_chunks(cs, st.error, fm.server_config.k)[:Tn]
        upd = torch.nn.functional.pad(upd, (0, 0, 0, 0, 0,
                                            Tn - upd.shape[0]))
        got, new = coll.quantized_all_gather(
            upd, group, sr["down"], residual=st.dres,
            block=cs.sublanes * 128, dtype=plan.downlink)
        contrib = upd + st.dres
        scale = float(contrib.abs().max())
        err = float((got[:Tn] + new - contrib).abs().max())
        assert err <= 1e-6 * max(scale, 1e-30), \
            f"{label}: downlink identity {err}"
        out["downlink_identity_max_err"] = err
    opt.step()
    return out


def nccl_world1(card: str, headline_rps: float) -> dict:
    """Step 2: a NCCL process group of one rank in this process. The
    ResNet9 headline round with ``--server_shard`` (fp32) bit-equal to the
    single-device round (2 rounds, one batch and seed, cuDNN
    deterministic); then TIMED_ROUNDS timed rounds each of the sharded
    fp32 round, the same with ``--fused_epilogue``, ``--collective_plan
    int8`` and
    ``uplink=int8,downlink=fp8_e4m3,table=int4``: finite losses, the
    launches a round per rank as derived (SHARDED_PER_ROUND), the engine's
    non-drain submits without a synchronizing call, and the quantized
    legs' error-feedback identity; rounds/sec beside phase 4's."""
    from commefficient_torch.parallel import (
        destroy_distributed,
        init_distributed,
        make_client_group,
    )

    out = {"card": card}
    batch = synthetic_batch()
    with tempfile.TemporaryDirectory() as tmp:
        device = init_distributed("cuda", init_method=f"file://{tmp}/store",
                                  rank=0, world_size=1, local_rank=0)
        try:
            group = make_client_group(8, -1, device)
            assert group.size == 1 and group.active
            with deterministic_cudnn():
                ws = []
                for grp, extra in ((None, []), (group, ["--server_shard"])):
                    _, fm, opt, sched, one_round = _build_group_round(
                        extra, grp)
                    ws.append([])
                    for i in range(2):
                        one_round(synthetic_batch(i))
                        ws[-1].append(_weights(fm))
                    del fm, opt, sched
            for i, (a, b) in enumerate(zip(*ws)):
                assert bit_equal(a, b), \
                    f"world-1 sharded round {i + 1} != single-device round"
            out["world1_bit_equal_rounds"] = len(ws[0])
            print("nccl world-1: the sharded headline round equals the "
                  "single-device round bit for bit (2 rounds, cuDNN "
                  "deterministic)")
            out["legs"] = {}
            for label, extra, per_round in (
                    ("sharded fp32", ["--server_shard"], SHARDED_PER_ROUND),
                    ("sharded fused epilogue", ["--server_shard",
                                                "--fused_epilogue"],
                     SHARDED_FUSED_PER_ROUND),
                    ("sharded int8", ["--server_shard", "--collective_plan",
                                      "int8"], SHARDED_PER_ROUND),
                    ("sharded mixed", ["--server_shard", "--collective_plan",
                                       "uplink=int8,downlink=fp8_e4m3,"
                                       "table=int4"], SHARDED_PER_ROUND)):
                _, fm, opt, sched, one_round = _build_group_round(extra,
                                                                  group)
                counts, rps = timed_rounds(one_round, batch, per_round,
                                           f"nccl {label}",
                                           n=TIMED_ROUNDS)
                row = {"rounds_per_sec": rps,
                       "launches_per_round_per_rank": {
                           kk: v // TIMED_ROUNDS for kk, v in
                           counts.items()}}
                if "int8" in label or "mixed" in label:
                    row.update(ef_identity(fm, opt, group,
                                           synthetic_batch(3), label))
                    st = opt.server_state
                    assert st.qres is not None and st.dres is not None
                    assert bool(st.qres.abs().max() > 0), label
                elif label == "sharded fp32":
                    # where the round's time goes, beside the
                    # single-device round's, and the host's operators
                    row["profile"] = profile_rounds(
                        lambda: one_round(batch), n=3)
                    row["host"] = host_ops(lambda: one_round(batch))
                    *_, one_single = _build_group_round([], None)
                    row["single_host"] = host_ops(lambda: one_single(batch))
                    del one_single
                    for name in ("host", "single_host"):
                        print(f"{label} {name}: " + json.dumps(row[name]))
                    # the engine's non-drain submits wait on nothing
                    audit = {"audited": 0, "fetches": 0, "drains": 0}
                    eng = PipelinedRoundEngine(fm, opt, sched, window=2,
                                               drain_every=8)
                    for _ in range(16):
                        audited_submit(eng, batch, audit)
                    eng.drain()
                    assert audit["fetches"] == 0 and audit["audited"] > 0
                    row["sync_audit"] = audit
                out["legs"][label] = row
                print(json.dumps({"phase": "multi", "step": "nccl world-1",
                                  "leg": label, **row}))
                del fm, opt, sched
            torch.cuda.empty_cache()
        finally:
            destroy_distributed()
    fp32 = out["legs"]["sharded fp32"]["rounds_per_sec"]
    print(f"rounds/sec: phase 4 headline {headline_rps:.3f}, nccl world-1 "
          f"sharded fp32 {fp32:.3f}, fused epilogue "
          f"{out['legs']['sharded fused epilogue']['rounds_per_sec']:.3f}, "
          f"int8 "
          f"{out['legs']['sharded int8']['rounds_per_sec']:.3f}, mixed "
          f"{out['legs']['sharded mixed']['rounds_per_sec']:.3f} ({card}, "
          "same call)")
    out["headline_rps"] = headline_rps
    return out


def table_row(output: str, key: str) -> dict:
    """The first row under the last ``TableLogger`` header holding
    ``key`` (columns of 12 characters and a space)."""
    def cells(line):
        return [line[i:i + 13].strip() for i in range(0, len(line), 13)]

    lines = output.splitlines()
    for i in range(len(lines) - 1, -1, -1):
        head = cells(lines[i])
        if key in head and i + 1 < len(lines):
            return dict(zip(head, cells(lines[i + 1])))
    raise AssertionError(f"no table row with {key} in the output")


def torchrun_entry(card: str) -> dict:
    """Step 3: ``torchrun --nproc_per_node 1 -m
    commefficient_torch.cv_train --server_shard --collective_plan int8``
    on synthetic CIFAR10 (16 images a class, 16 clients, one epoch) in a
    subprocess with a 300 s timeout: exit 0 and finite losses."""
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, COMMEFFICIENT_SYNTHETIC_PER_CLASS="16",
                   PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "1", "-m", "commefficient_torch.cv_train",
               *HEADLINE, "--server_shard", "--collective_plan", "int8",
               "--dataset_dir", os.path.join(tmp, "cifar10"), "--iid",
               "--num_clients", "16", "--num_epochs", "1", "--seed", "0"]
        t = time.perf_counter()
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=300)
        wall = time.perf_counter() - t
    if proc.returncode != 0:
        print(proc.stdout[-4000:])
        print(proc.stderr[-4000:], file=sys.stderr)
    assert proc.returncode == 0, f"torchrun cv_train exit {proc.returncode}"
    row = table_row(proc.stdout, "train_loss")
    for key in ("train_loss", "test_loss"):
        assert np.isfinite(float(row[key])), row
    out = {"phase": "multi", "step": "torchrun cv_train", "row": row,
           "wall_s": wall, "card": card}
    print(json.dumps(out))
    return out


def _gloo_rank(rank: int, n: int, tmp: str) -> None:
    """One rank of step 4: gloo on ``cuda:0``, the headline round sharded,
    replicated and sharded under ``--fused_epilogue`` from the seed; the
    weights and the kernels' launches of each round (counts set to 0 just
    before it) written to ``tmp``."""
    import torch.distributed as dist

    from commefficient_torch.parallel import ClientGroup

    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=n)
    try:
        kernels.library()
        group = ClientGroup(None, rank, n, torch.device("cuda", 0))
        with deterministic_cudnn():
            for name, extra in (("sharded", ["--server_shard"]),
                                ("replicated", []),
                                ("fused", ["--server_shard",
                                           "--fused_epilogue"])):
                _, fm, opt, sched, one_round = _build_group_round(extra,
                                                                  group)
                kernels.reset_launch_counts()
                loss = one_round(synthetic_batch(0))[0]
                assert np.all(np.isfinite(loss))
                np.save(os.path.join(tmp, f"{name}{rank}.npy"),
                        _weights(fm).cpu().numpy())
                with open(os.path.join(tmp, f"{name}{rank}.json"), "w") as f:
                    json.dump(kernels.launch_counts(), f)
                del fm, opt, sched
    finally:
        dist.destroy_process_group()


def gloo_two_ranks(card: str, world1_w: np.ndarray) -> dict:
    """Step 4: two gloo ranks on the one card (gloo takes all_reduce,
    all_gather_into_tensor, reduce_scatter_tensor and all_to_all_single
    on CUDA tensors, PERF.md; two NCCL ranks cannot share a GPU). One
    sharded, one replicated and one sharded ``--fused_epilogue`` headline
    round from the seed: the ranks' weights equal, sharded equal to
    replicated bit for bit (a sum of two addends has one order), and
    within ``rtol=1e-4, atol=1e-6`` of the one-rank round with 99% of its
    kept set (the ranks sum the client gradients in another order). Rank
    1's launches (its chunks start at ``t0 = 7``) equal the launches a
    round per rank derived from the code (SHARDED_PER_ROUND,
    SHARDED_FUSED_PER_ROUND)."""
    import multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_gloo_rank, args=(r, 2, tmp))
                 for r in range(2)]
        t = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(max(1.0, 300 - (time.perf_counter() - t)))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        assert not alive, "gloo ranks timed out"
        assert all(p.exitcode == 0 for p in procs), \
            [p.exitcode for p in procs]
        w = {f"{nm}{r}": np.load(os.path.join(tmp, f"{nm}{r}.npy"))
             for nm in ("sharded", "replicated", "fused") for r in (0, 1)}
        counts = {}
        for nm in ("sharded", "fused"):
            with open(os.path.join(tmp, f"{nm}1.json")) as f:
                counts[nm] = json.load(f)
    for nm, want in (("sharded", SHARDED_PER_ROUND),
                     ("fused", SHARDED_FUSED_PER_ROUND)):
        got = {k: v for k, v in counts[nm].items() if v}
        assert got == want, f"gloo rank 1 {nm} launches {got} != {want}"
    u32 = {k: v.view(np.uint32) for k, v in w.items()}
    assert np.array_equal(u32["sharded0"], u32["sharded1"]), "ranks differ"
    assert np.array_equal(u32["fused0"], u32["fused1"]), "fused ranks differ"
    assert np.all(np.isfinite(w["fused0"]))
    assert np.array_equal(u32["sharded0"], u32["replicated0"]), \
        "2-rank sharded != replicated"
    w0 = _weights_init_headline()
    np.testing.assert_allclose(w["sharded0"], world1_w, rtol=1e-4, atol=1e-6)
    a = set(np.flatnonzero(w["sharded0"] != w0))
    b = set(np.flatnonzero(world1_w != w0))
    overlap = len(a & b) / max(len(b), 1)
    assert overlap >= 0.99, overlap
    out = {"phase": "multi", "step": "gloo 2 ranks on cuda:0",
           "kept_overlap_with_world1": overlap,
           "launches_rank1": counts["sharded"],
           "launches_rank1_fused_epilogue": counts["fused"],
           "fused_max_abs_diff_vs_sharded": float(np.abs(
               w["fused0"] - w["sharded0"]).max()),
           "max_abs_diff_vs_world1": float(np.abs(w["sharded0"]
                                                  - world1_w).max()),
           "wall_s": time.perf_counter() - t, "card": card}
    print(json.dumps(out))
    return out


def _weights_init_headline() -> np.ndarray:
    """The headline model's seeded initial weights (flat)."""
    from commefficient_torch.federated.aggregator import init_model_
    from commefficient_torch.ops.flat import ParamLayout

    m = ResNet9()
    init_model_(m, 0)
    return ParamLayout(m).flatten(dict(m.named_parameters())).numpy()


def hf_gpt2_state(seed: int = 0) -> dict:
    """A seeded GPT-2-small state dict under HF's names (vocab 50,257,
    1,024 positions, 12 layers of 768; ``Conv1D`` weights ``(in,
    out)``)."""
    gen = torch.Generator().manual_seed(seed)
    E, V, P, L = 768, 50_257, 1024, 12

    def t(*shape, std=0.02, base=0.0):
        return base + std * torch.randn(shape, generator=gen)

    sd = {"transformer.wte.weight": t(V, E),
          "transformer.wpe.weight": t(P, E, std=0.01)}
    for i in range(L):
        p = f"transformer.h.{i}."
        sd.update({
            p + "ln_1.weight": t(E, std=0.1, base=1.0), p + "ln_1.bias": t(E),
            p + "attn.c_attn.weight": t(E, 3 * E),
            p + "attn.c_attn.bias": t(3 * E),
            p + "attn.c_proj.weight": t(E, E), p + "attn.c_proj.bias": t(E),
            p + "ln_2.weight": t(E, std=0.1, base=1.0), p + "ln_2.bias": t(E),
            p + "mlp.c_fc.weight": t(E, 4 * E), p + "mlp.c_fc.bias": t(4 * E),
            p + "mlp.c_proj.weight": t(4 * E, E),
            p + "mlp.c_proj.bias": t(E)})
    sd["transformer.ln_f.weight"] = t(E, std=0.1, base=1.0)
    sd["transformer.ln_f.bias"] = t(E)
    return sd


def write_safetensors(path: str, sd: dict) -> None:
    """The safetensors layout (float32): an 8-byte little-endian header
    length, the JSON header, the raw bytes."""
    header, off = {}, 0
    for name, x in sd.items():
        n = x.numel() * 4
        header[name] = {"dtype": "F32", "shape": list(x.shape),
                        "data_offsets": [off, off + n]}
        off += n
    h = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(len(h).to_bytes(8, "little"))
        f.write(h)
        for x in sd.values():
            f.write(x.contiguous().numpy().tobytes())


def hf_gpt2(card: str, gpt2_f32: dict) -> dict:
    """Step 5: a seeded GPT-2-small checkpoint written as
    ``model.safetensors`` and ``pytorch_model.bin``; both loaded
    (``load_hf_gpt2``) bit-equal; the run's initial weights from it (HF
    rows kept, the embedding grown to 50,262) and the load's time;
    GPT2_TIMED_ROUNDS timed rounds from those weights (tokens/sec, peak
    memory, beside phase 9's f32 leg); ``gpt2_train`` for 2 rounds from
    the directory and ``--finetune`` on its run dir: a finite val NLL and
    the loaded leaves the saved ones."""
    from commefficient_torch import gpt2_train
    from commefficient_torch.convert import flax_from_port, params_from_flax
    from commefficient_torch.data_utils.tokenization import (
        ATTR_TO_SPECIAL_TOKEN,
        get_tokenizer,
    )
    from commefficient_torch.federated.checkpoint import load_checkpoint
    from commefficient_torch.models.gpt2 import load_hf_gpt2
    from commefficient_torch.ops.flat import ParamLayout

    out = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        sd = hf_gpt2_state()
        st_dir, bin_dir = os.path.join(tmp, "st"), os.path.join(tmp, "bin")
        os.makedirs(st_dir)
        os.makedirs(bin_dir)
        t = time.perf_counter()
        write_safetensors(os.path.join(st_dir, "model.safetensors"), sd)
        torch.save(sd, os.path.join(bin_dir, "pytorch_model.bin"))
        out["write_s"] = time.perf_counter() - t
        model = GPT2DoubleHeads(**GPT2_MODEL)
        layout = ParamLayout(model)
        template = flax_from_port(dict(model.named_parameters()), layout)
        loaded = {}
        for name, dr in (("safetensors", st_dir), ("bin", bin_dir)):
            t = time.perf_counter()
            loaded[name] = load_hf_gpt2(template, dr)
            out[f"load_{name}_s"] = time.perf_counter() - t

        def leaves(tree, prefix=()):
            for kk in sorted(tree):
                if isinstance(tree[kk], dict):
                    yield from leaves(tree[kk], prefix + (kk,))
                else:
                    yield prefix + (kk,), tree[kk]

        pairs = list(zip(leaves(loaded["safetensors"]),
                         leaves(loaded["bin"])))
        assert len(pairs) == 150, len(pairs)
        for (pa, a), (pb, b) in pairs:
            assert pa == pb and np.array_equal(a.view(np.uint32),
                                               b.view(np.uint32)), pa
        assert np.array_equal(loaded["bin"]["wte"]["embedding"],
                              sd["transformer.wte.weight"].numpy())
        del loaded, pairs

        tok = get_tokenizer("gpt2")
        tok.add_special_tokens(ATTR_TO_SPECIAL_TOKEN)
        args = parse_args(default_lr=4e-2, argv=GPT2_BASE + [
            "--dataset_name", "PERSONA", "--num_clients", "8",
            "--model_checkpoint", st_dir])
        t = time.perf_counter()
        flat, what = gpt2_train.initial_weights(args, model, len(tok))
        out["initial_weights_s"] = time.perf_counter() - t
        assert what == "local pretrained GPT-2 weights", what
        wte = layout.params(flat)["wte.embedding"]
        assert wte.shape == (50_262, 768)
        assert torch.equal(wte[:50_257], sd["transformer.wte.weight"])
        print(f"hf gpt2: wrote both files in {out['write_s']:.2f} s, loaded "
              f"safetensors {out['load_safetensors_s']:.2f} s, bin "
              f"{out['load_bin_s']:.2f} s (bit-equal, 150 leaves), initial "
              f"weights {out['initial_weights_s']:.2f} s")

        # timed rounds from the HF weights
        train_loss, val_loss = make_gpt2_losses(model)
        torch.cuda.reset_peak_memory_stats()
        fm = FedModel(model, train_loss, args, val_loss, num_clients=8,
                      init_params=flat)
        opt = FedOptimizer(fm, args)
        sched = LambdaLR(opt, lambda step: 0.04)

        def one_round(batch):
            sched.step()
            res = fm(batch)
            opt.step()
            return res

        _, rps = timed_rounds(one_round, gpt2_batch(), HEADLINE_PER_ROUND,
                              "hf gpt2", n=GPT2_TIMED_ROUNDS)
        tokens = GPT2_W * GPT2_B * GPT2_C * GPT2_T
        out["tokens_per_sec"] = rps * tokens
        out["peak_memory_GB"] = torch.cuda.max_memory_allocated() / 1e9
        del fm, opt, sched, model
        torch.cuda.empty_cache()
        print(f"hf gpt2 tokens/sec {out['tokens_per_sec']:.1f} (phase 9 f32 "
              f"{gpt2_f32['tokens_per_sec']:.1f}), peak memory "
              f"{out['peak_memory_GB']:.2f} GB (phase 9 f32 "
              f"{gpt2_f32['peak_memory_GB']:.2f}) ({card}, same call)")

        # gpt2_train for 2 rounds from the directory, then --finetune
        os.environ["COMMEFFICIENT_SYNTHETIC_CLIENTS"] = "8"
        data = ["--dataset_dir", os.path.join(tmp, "persona")]
        try:
            loader, _ = gpt2_train.get_data_loaders(
                parse_args(default_lr=4e-2, argv=GPT2_BASE + data), tok)
            spe = loader.steps_per_epoch()
            os.environ["COMMEFFICIENT_RUN_DIR"] = os.path.join(tmp, "run")
            kernels.reset_launch_counts()
            stats = gpt2_train.train(GPT2_BASE + data + [
                "--model_checkpoint", st_dir,
                "--num_epochs", str(1.5 / spe)])
            counts = kernels.launch_counts()
            assert np.isfinite(stats["val_nll"]), stats
            assert counts["sketch_estimates"] == 2, counts  # 2 rounds
            os.environ["COMMEFFICIENT_RUN_DIR"] = os.path.join(tmp, "ft")
            ft = GPT2_BASE + data + ["--finetune", "--finetune_path",
                                     os.path.join(tmp, "run")]
            ft_stats = gpt2_train.train(ft)
        finally:
            os.environ.pop("COMMEFFICIENT_SYNTHETIC_CLIENTS", None)
            os.environ.pop("COMMEFFICIENT_RUN_DIR", None)
        assert np.isfinite(ft_stats["val_nll"]), ft_stats
        fargs = parse_args(default_lr=4e-2, argv=ft)
        fargs.model_checkpoint = fargs.finetune_path
        fmodel = GPT2DoubleHeads(**GPT2_MODEL)
        fflat, fwhat = gpt2_train.initial_weights(fargs, fmodel, len(tok))
        flayout = ParamLayout(fmodel)
        saved, _ = load_checkpoint(os.path.join(tmp, "run", "model"))
        want = flayout.flatten(params_from_flax(saved, flayout))
        assert torch.equal(fflat, want), "finetune loaded other weights"
        assert fwhat == "saved run dir: 150 tensors, fresh: 0", fwhat
    out.update(val_nll=float(stats["val_nll"]),
               finetune_val_nll=float(ft_stats["val_nll"]),
               finetune_loaded=fwhat, rounds=2)
    print(json.dumps({"phase": "multi", "step": "hf gpt2", **out}))
    return out


def phase_multi(card: str, headline_rps: float, gpt2_f32: dict) -> dict:
    """Phase 11: the multi-GPU data plane and HF GPT-2 weights."""
    out = {"kernels": {label: sharded_kernels(card, label, d, 20 + i)
                       for i, (label, d) in enumerate(SHARD_GEOMETRIES)}}
    out["nccl"] = nccl_world1(card, headline_rps)
    out["torchrun"] = torchrun_entry(card)
    # the one-rank round's weights after one round, for step 4
    with deterministic_cudnn():
        _, fm, opt, sched, one_round = _build_group_round([], None)
        one_round(synthetic_batch(0))
        world1_w = _weights(fm).cpu().numpy()
        del fm, opt, sched
    torch.cuda.empty_cache()
    out["gloo"] = gloo_two_ranks(card, world1_w)
    out["hf"] = hf_gpt2(card, gpt2_f32)
    return out


# phase 12: the observability plane and the health guards
OBS_ON = ["--telemetry", "--telemetry_hist", "--watch", "--guards"]
OBS_IDENTITY_ROUNDS = 10
OBS_AUDIT_ROUNDS = 16
# alternating pairs of the cost phase: the host-bound ResNet9 round moves
# 10-40% between windows of one call, the GPT-2 round under 1%
OBS_PAIRS = {"headline": 4, "gpt2 f32": 1}
OBS_PAIR_ROUNDS = 16
# the profiled window of the host split: one drain cycle of the engine
# (the profiler's event processing is slow at GPT-2's 7,800 operators a
# round)
OBS_HOST_ROUNDS = 8
# the metric vector on the card against the same function on the CPU:
# norms to float32 summation order, counts, nnz, threshold and verdict
# exact
OBS_NORM_RTOL = 1e-5
OBS_EXACT = ("update_nnz", "topk_threshold", "guard_ok", "qres_norm",
             "dres_norm") + tuple(f for f in METRIC_FIELDS if "_hist_" in f)


def _cpu_state(state):
    return type(state)(*(None if x is None else x.detach().cpu()
                         for x in state))


def _clone_states(fm):
    return ClientStates(*(None if x is None else x.clone()
                          for x in fm.client_states))


def metric_vector_check(label: str, fm, opt, batch) -> dict:
    """One server step of ``fm`` (telemetry, histograms and guards on)
    from the round context of ``batch``: its metric vector, computed on
    the card, against ``device_round_metrics`` on the CPU from the
    fetched planes (the transmit, the update recomputed by the same
    ``server_update``, the new weights and state). Returns the tensors
    for the cost phase."""
    fm.begin_round(batch)
    ctx, lr = fm._round_ctx, opt.get_lr()
    ps, ss = fm.ps_weights, opt.server_state
    new_ps, new_ss, _, ok, tel = fm.steps.server_step(
        ps, ss, _clone_states(fm), ctx, lr, fm._rng)
    update, st = server_update(ctx.gradient, ss, fm.server_config, lr,
                               sketch=fm.sketch, layout=fm.layout)
    torch.cuda.synchronize()
    assert bool(ok), f"{label}: a healthy round tripped the guard"
    assert bit_equal(new_ps, ps - update), f"{label}: weights differ"
    assert bit_equal(new_ss.error, st.error), f"{label}: error differs"
    want = device_round_metrics(
        ctx.gradient.cpu(), update.cpu(), new_ps.cpu(), _cpu_state(new_ss),
        guard_ok=ok.cpu(), hists=True).numpy()
    got = tel.cpu().numpy()
    assert got.shape == (len(METRIC_FIELDS),), got.shape
    worst = 0.0
    for i, name in enumerate(METRIC_FIELDS):
        if name in OBS_EXACT:
            assert got[i] == want[i], f"{label} {name}: {got[i]} != {want[i]}"
        else:
            assert np.isclose(got[i], want[i], rtol=OBS_NORM_RTOL, atol=0), \
                f"{label} {name}: {got[i]} vs {want[i]}"
            if want[i]:
                worst = max(worst, abs(got[i] - want[i]) / abs(want[i]))
    print(f"{label} metric vector on the card equals the CPU's: counts, "
          f"nnz ({int(got[3])}), threshold ({got[4]:.6g}) and verdict "
          f"exact; norms within rtol {worst:.3g} (limit {OBS_NORM_RTOL})")
    print(f"{label} metrics: " + json.dumps(
        {k: float(v) for k, v in zip(METRIC_FIELDS, got)}))
    fm._round_ctx = None
    return {"transmit": ctx.gradient, "update": update, "new_ps": new_ps,
            "state": new_ss, "ps": ps, "old_state": ss, "ok": ok}


def reduction_costs(label: str, planes: dict, n: int = 5) -> dict:
    """Device ms and kernels per call of the metric vector and of the
    guard (verdict and selects) on one round's tensors
    (``torch.profiler``)."""

    def metrics():
        device_round_metrics(planes["transmit"], planes["update"],
                             planes["new_ps"], planes["state"],
                             guard_ok=planes["ok"], hists=True)

    def guard():
        ok = round_health(planes["transmit"], planes["new_ps"])
        torch.where(ok, planes["new_ps"], planes["ps"])
        for new, old in zip(planes["state"], planes["old_state"]):
            if new is not None:
                torch.where(ok, new, old)

    out = {}
    for name, fn in (("metrics", metrics), ("guard", guard)):
        fn()
        rows, _ = device_rows(fn, n)
        out[name] = {"device_ms": sum(dev_us(e) for e in rows) / 1e3 / n,
                     "device_ops": sum(e.count for e in rows) / n}
        for e in rows[:6]:
            print(f"  {label} {name}: {dev_us(e) / n / 1e3:7.4f} ms "
                  f"{e.count / n:4.1f} x {e.key[:80]}")
    print(f"{label} per round: metric vector {out['metrics']['device_ms']:.4f}"
          f" device ms in {out['metrics']['device_ops']:g} device "
          f"operations, guard {out['guard']['device_ms']:.4f} ms in "
          f"{out['guard']['device_ops']:g}")
    return out


def obs_identity(label: str, build, batches) -> None:
    """OBS_IDENTITY_ROUNDS rounds with telemetry and guards on against the
    same rounds with both off, cuDNN deterministic: losses, weights,
    server state and client rows bit-equal."""
    runs = []
    for extra in (OBS_ON, []):
        with deterministic_cudnn():
            _, fm, opt, _, one_round = build(extra)
            losses = [one_round(batches[i % len(batches)])[0]
                      for i in range(OBS_IDENTITY_ROUNDS)]
            torch.cuda.synchronize()
        runs.append((losses, fm, opt))
    (la, fa, oa), (lb, fb, ob) = runs
    for a, b in zip(la, lb):
        assert np.array_equal(a, b), f"{label}: losses differ on/off"
    pairs = [("weights", fa.ps_weights, fb.ps_weights)]
    pairs += [(n, a, b) for n, a, b in zip(
        oa.server_state._fields, oa.server_state, ob.server_state)
        if a is not None]
    pairs += [(f"client {n}", a, b) for n, a, b in zip(
        ClientStates._fields, fa.client_states, fb.client_states)
        if a is not None]
    for name, a, b in pairs:
        assert bit_equal(a, b), f"{label}: {name} differs on/off"
    print(f"{label}: {OBS_IDENTITY_ROUNDS} rounds with telemetry and guards "
          f"on equal to the rounds with both off, bit for bit: losses, "
          + ", ".join(n for n, _, _ in pairs))
    del runs, fa, fb, oa, ob
    torch.cuda.empty_cache()


def attach_recorder(fm, path: str):
    """A run event log at ``path`` with the default watch rules."""
    rt = RunTelemetry(path, run_info={"mode": fm.args.mode,
                                      "grad_size": fm.grad_size},
                      schema=METRIC_FIELDS)
    rt.watch = WatchEngine(parse_watch_rules(",".join(DEFAULT_WATCH_RULES)),
                           telemetry=rt)
    fm.telemetry = rt
    return rt


def obs_audit(tmp: str) -> dict:
    """The strict audit with telemetry, histograms, watch and guards on:
    OBS_AUDIT_ROUNDS headline rounds through the engine (window 2, drain
    every 8), every non-drain submit under ``set_sync_debug_mode("error")``
    with no fetch, every drain one counted fetch; the event log holds every
    round with the full schema, healthy."""
    _, fm, opt, sched, _ = build_round(OBS_ON + ["--snapshot_every", "4"])
    rt = attach_recorder(fm, os.path.join(tmp, "audit", "telemetry.jsonl"))
    eng = PipelinedRoundEngine(fm, opt, sched, window=2, drain_every=8)
    batches = [synthetic_batch(s) for s in range(8)]
    drains, audited = [], 0
    torch.cuda.synchronize()
    for i in range(OBS_AUDIT_ROUNDS):
        if eng.pending + 1 < eng.drain_every:
            with host_sync_monitor(strict=True) as counter:
                assert eng.submit(batches[i % 8]) == []
            assert counter.count == 0, f"round {i}: {counter.count} fetches"
            audited += 1
        else:
            with host_sync_monitor() as counter:
                eng.submit(batches[i % 8])
            drains.append(counter.count)
    eng.drain()
    rt.close()
    assert drains == [1] * (OBS_AUDIT_ROUNDS // 8), drains
    events = list(read_events(rt.path))
    rounds = [e for e in events if e["ev"] == "round"]
    assert [e["round"] for e in rounds] == list(range(OBS_AUDIT_ROUNDS))
    for e in rounds:
        assert set(e["metrics"]) == set(METRIC_FIELDS) and e["guard_ok"]
    assert fm.guard_trips == 0 and fm._snapshot is not None
    print(f"audit: {audited} non-drain submits with telemetry, histograms, "
          f"watch and guards on under set_sync_debug_mode('error'), 0 "
          f"fetches; {len(drains)} drains of one fetch each; "
          f"{len(rounds)} round lines, {rt.watch.alerts} watch alerts")
    del fm, opt, sched, eng
    torch.cuda.empty_cache()
    return {"audited": audited, "drain_fetches": drains}


def _state_of(fm, opt):
    return ([("weights", fm.ps_weights)]
            + [(n, x) for n, x in zip(opt.server_state._fields,
                                      opt.server_state) if x is not None]
            + [(f"client {n}", x) for n, x in zip(ClientStates._fields,
                                                  fm.client_states)
               if x is not None])


def _snapshot_of(fm, opt):
    return [(n, x.clone()) for n, x in _state_of(fm, opt)]


def _assert_state(label, fm, opt, snap, what):
    for (n, a), (_, b) in zip(_state_of(fm, opt), snap):
        assert bit_equal(a, b), f"{label}: {n} differs from {what}"


def poisoned_round(label: str, fm, opt, sched, batch, kind: str) -> None:
    """Round ``fm.rounds_dispatched`` is poisoned (``--inject_fault``):
    its server step through the kernels and through the plain versions
    gives the same update, verdict and metrics (NaN positions matched);
    the real step trips the verdict, leaves weights, server state and
    client rows bit-equal to the state before it, and its metric vector
    shows the non-finite transmit with guard_ok 0."""
    before = _snapshot_of(fm, opt)
    sched.step()
    h = fm.begin_round(batch)
    ctx, lr = fm._round_ctx, opt.get_lr()
    assert not bool(torch.isfinite(ctx.gradient).all()), "not poisoned"
    out_k = fm.steps.server_step(fm.ps_weights, opt.server_state,
                                 _clone_states(fm), ctx, lr, fm._rng)
    with plain_kernels():
        out_p = fm.steps.server_step(fm.ps_weights, opt.server_state,
                                     _clone_states(fm), ctx, lr, fm._rng)
    upd_k = server_update(ctx.gradient, opt.server_state, fm.server_config,
                          lr, sketch=fm.sketch, layout=fm.layout)[0]
    with plain_kernels():
        upd_p = server_update(ctx.gradient, opt.server_state,
                              fm.server_config, lr, sketch=fm.sketch,
                              layout=fm.layout)[0]
    torch.cuda.synchronize()
    assert nan_equal(upd_k, upd_p), f"{label}: poisoned update differs"
    assert torch.equal(out_k[3], out_p[3]) and not bool(out_k[3])
    assert nan_equal(out_k[4], out_p[4]), f"{label}: metrics differ"
    for x, y in zip((out_k[0], *out_k[1], *out_k[2]),
                    (out_p[0], *out_p[1], *out_p[2])):
        if x is not None:
            assert bit_equal(x, y), f"{label}: state kernels != plain"
    n_nan = int(torch.isnan(upd_k).sum())
    opt.step()
    h = fm.seal_round(h)
    tel = h.telemetry.cpu().numpy()
    assert not bool(h.guard), f"{label}: the verdict did not trip"
    fm.finish_round(h)
    _assert_state(label, fm, opt, before, "the state before the round")
    m = dict(zip(METRIC_FIELDS, tel))
    assert m["guard_ok"] == 0 and not np.isfinite(m["transmit_norm"]) \
        and not np.isfinite(m["transmit_max_abs"]), m
    print(f"{label} {kind} round {h.round_no}: verdict tripped; weights, "
          f"server state and client rows bit-equal to before; update "
          f"({n_nan} NaN), verdict and metrics equal through kernels and "
          f"plain versions; transmit_norm {m['transmit_norm']}, "
          f"update_hist_7 {m['update_hist_7']:g}, guard_ok 0")


def guard_ladder(label: str, extra) -> dict:
    """Fault injection through the kernels of the round ``extra`` names,
    through the engine with a drain every round (the guard ladder runs at
    the drain): one model trips once on a NaN (logged, state kept) and
    then trains on; a second trips on inf at round 3 (kept), again at 4
    (the snapshot of round 2 restored, bit-equal) and at 5
    (``--max_guard_trips 3``: the raise is asserted)."""
    batches = [synthetic_batch(s) for s in range(8)]

    def engine(inject, *more):
        _, fm, opt, sched, _ = build_round(
            extra + OBS_ON + ["--snapshot_every", "1", "--inject_fault",
                              inject, *more])
        return fm, opt, sched, PipelinedRoundEngine(fm, opt, sched,
                                                    window=2, drain_every=1)

    fm, opt, sched, eng = engine("3:nan")
    for i in range(3):
        eng.submit(batches[i])
    poisoned_round(label, fm, opt, sched, batches[3], "nan")
    (res,) = eng.submit(batches[4])
    assert np.all(np.isfinite(res.values[0])) and fm.guard_trips == 1
    del fm, opt, sched, eng
    fm, opt, sched, eng = engine("3:inf,4:nan,5:inf", "--max_guard_trips",
                                 "3")
    with tempfile.TemporaryDirectory() as tmp:
        rt = attach_recorder(fm, os.path.join(tmp, "telemetry.jsonl"))
        eng.telemetry = rt
        _ladder_rollback_abort(label, fm, opt, sched, eng, batches)
        rt.close()
        ladder = [(e["ev"], e.get("round")) for e in read_events(rt.path)
                  if e["ev"] in ("guard_trip", "rollback", "guard_fatal")]
    assert ladder == [("guard_trip", 3), ("guard_trip", 4), ("rollback", 4),
                      ("guard_trip", 5), ("guard_fatal", 5)], ladder
    print(f"{label}: two consecutive trips restored the snapshot bit for "
          f"bit; the third raised RuntimeError; events {ladder}")
    del fm, opt, sched, eng
    torch.cuda.empty_cache()
    return {"events": ladder}


def _ladder_rollback_abort(label, fm, opt, sched, eng, batches) -> None:
    for i in range(3):
        eng.submit(batches[i])
    snap = _snapshot_of(fm, opt)
    poisoned_round(label, fm, opt, sched, batches[3], "inf")
    eng.submit(batches[4])   # the second consecutive trip rolls back
    assert fm.guard_trips == 2
    _assert_state(label, fm, opt, snap, "the snapshot")
    try:
        eng.submit(batches[5])
    except RuntimeError as e:
        assert "health guard tripped 3 consecutive rounds" in str(e), e
    else:
        raise AssertionError(f"{label}: --max_guard_trips 3 did not raise")


def obs_cli(tmp: str) -> dict:
    """``python -m commefficient_torch.cv_train`` with the telemetry
    defaults and ``--guards --inject_fault 3:nan --trace_rounds 2:2``:
    the event log read back with the port's ``read_events`` holds round
    3's trip and the capture of rounds 2-3, whose directory exists."""
    run = os.path.join(tmp, "cli_run")
    argv = [a for a in HEADLINE if a != "--no_telemetry"] + [
        "--model", "ResNet9", "--iid", "--num_clients", "16",
        "--num_epochs", "1", "--seed", "0", "--dataset_dir",
        os.path.join(tmp, "c10"), "--guards", "--inject_fault", "3:nan",
        "--trace_rounds", "2:2"]
    out = run_cv_train(argv, {"COMMEFFICIENT_SYNTHETIC_PER_CLASS": 64,
                              "COMMEFFICIENT_RUN_DIR": run})
    events = list(read_events(os.path.join(run, "telemetry.jsonl")))
    kinds = [e["ev"] for e in events]
    trips = [e for e in events if e["ev"] == "guard_trip"]
    caps = [e for e in events if e["ev"] == "trace_captured"]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end", kinds
    assert [e["round"] for e in trips] == [3], trips
    assert caps and caps[0]["round_start"] == 2 \
        and caps[0]["round_until"] == 3, caps
    trace_dir = os.path.join(run, "trace_round_000002")
    assert os.path.isfile(os.path.join(trace_dir, "trace.json")), trace_dir
    rounds = {e["round"]: e for e in events if e["ev"] == "round"}
    assert rounds[3]["guard_ok"] is False
    assert rounds[3]["metrics"]["transmit_norm"] == "nan"
    size = os.path.getsize(os.path.join(trace_dir, "trace.json"))
    print(f"cv_train CLI: {len(events)} events ({len(rounds)} rounds), the "
          f"trip at round 3, trace of rounds 2-3 in {trace_dir} "
          f"({size:,} B); " + json.dumps(out))
    return {"events": len(events), "rounds": len(rounds)}


def clock_recorder(rt) -> dict:
    """Wrap the recorder's host hooks (the spans, the metric records with
    the watch engine, the event writes) with a clock: ``spent["s"]`` sums
    the seconds of the outermost calls."""
    spent = {"s": 0.0, "depth": 0}
    for name in ("on_dispatch", "on_complete", "on_metrics", "on_drained",
                 "event"):
        def timed(*a, _fn=getattr(rt, name), **k):
            spent["depth"] += 1
            t = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                spent["depth"] -= 1
                if spent["depth"] == 0:
                    spent["s"] += time.perf_counter() - t
        setattr(rt, name, timed)
    return spent


def engine_host_ops(eng, batch) -> dict:
    """The host's operators over OBS_HOST_ROUNDS engine rounds and their
    drain under ``torch.profiler`` (CPU only): self time, operators and
    kernel launches a round."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(OBS_HOST_ROUNDS):
            eng.submit(batch)
        eng.drain()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    n = OBS_HOST_ROUNDS
    return {"self_cpu_ms_per_round": sum(e.self_cpu_time_total
                                         for e in rows) / n / 1e3,
            "aten_ops_per_round": sum(e.count for e in rows
                                      if e.key.startswith("aten::")) / n,
            "launches_per_round": sum(e.count for e in rows
                                      if e.key == "cudaLaunchKernel") / n}


def obs_costs(card: str, label: str, build, batch, per_round, tmp) -> dict:
    """Rounds/sec with telemetry (histograms, watch, the event log) on
    against ``--no_telemetry``, and with guards on against off, through
    the engine (window 2, drain every 8), in ``OBS_PAIRS[label]``
    alternating pairs of OBS_PAIR_ROUNDS rounds each; the launches of
    every timed window checked (the planes launch no port kernel). The
    host's side of telemetry on and off: the recorder's hooks' seconds a
    round in the timed windows (``clock_recorder``), and one profiled
    window each (``engine_host_ops``). Data: no exit code depends on a
    ratio."""
    engines = {}
    for cfg, extra in (("off", []), ("telemetry", ["--telemetry"]),
                       ("guards", ["--guards"])):
        _, fm, opt, sched, _ = build(extra)
        if cfg == "telemetry":
            rec = clock_recorder(attach_recorder(
                fm, os.path.join(tmp, label.replace(" ", "_"),
                                 "telemetry.jsonl")))
        engines[cfg] = PipelinedRoundEngine(fm, opt, sched, window=2,
                                            drain_every=8)
        for _ in range(3):
            engines[cfg].submit(batch)
        engines[cfg].drain()

    rec_ms = []

    def run(cfg):
        eng = engines[cfg]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        rec0 = rec["s"]
        t0 = time.perf_counter()
        for _ in range(OBS_PAIR_ROUNDS):
            eng.submit(batch)
        eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if cfg == "telemetry":
            rec_ms.append((rec["s"] - rec0) / OBS_PAIR_ROUNDS * 1e3)
        counts = kernels.launch_counts()
        want = {k.name: per_round.get(k.name, 0) * OBS_PAIR_ROUNDS
                for k in kernels.KERNELS}
        assert counts == want, f"{label} {cfg}: launches {counts}"
        return OBS_PAIR_ROUNDS / wall

    ratios = {"telemetry": [], "guards": []}
    rps = {"off": [], "telemetry": [], "guards": []}
    pairs = OBS_PAIRS[label]
    for p in range(pairs):
        for cmp in ("telemetry", "guards"):
            order = ("off", cmp) if p % 2 == 0 else (cmp, "off")
            r = {c: run(c) for c in order}
            for c, v in r.items():
                rps[c].append(v)
            ratios[cmp].append(r[cmp] / r["off"])
    host = {cfg: engine_host_ops(engines[cfg], batch)
            for cfg in ("off", "telemetry")}
    host["recorder_ms_per_round"] = statistics.median(rec_ms)
    row = {"phase": "observability", "leg": label,
           "pairs": pairs, "rounds_per_window": OBS_PAIR_ROUNDS,
           "rounds_per_sec": rps,
           **{f"{k}_ratio": {"median": statistics.median(v),
                             "min": min(v), "max": max(v), "all": v}
              for k, v in ratios.items()},
           "host": host, "card": card}
    print(json.dumps(row))
    for k, v in ratios.items():
        print(f"{label} {k} on / off: median {statistics.median(v):.4f} "
              f"(spread {min(v):.4f}-{max(v):.4f}) against the JAX "
              f"package's budget of >= 0.98 (data, not a gate)")
    off, on = host["off"], host["telemetry"]
    print(f"{label} host a round, telemetry on / off: operators' self "
          f"time {on['self_cpu_ms_per_round']:.3f} / "
          f"{off['self_cpu_ms_per_round']:.3f} ms, "
          f"{on['aten_ops_per_round']:.1f} / "
          f"{off['aten_ops_per_round']:.1f} operators, "
          f"{on['launches_per_round']:.1f} / "
          f"{off['launches_per_round']:.1f} launches; the recorder's "
          f"hooks {host['recorder_ms_per_round']:.3f} ms")
    for eng in engines.values():
        rt = getattr(eng.model, "telemetry", None)
        if rt is not None:
            rt.close()
    del engines
    torch.cuda.empty_cache()
    return row


def phase_observability(card: str) -> dict:
    """Phase 12: the observability plane and the health guards at full
    width (cuDNN deterministic where bits are compared)."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (1) the metric vector on the card against the CPU's, with the
        # launches of each leg's rounds checked
        planes = {}
        for label, extra in (("headline", []), ("opt-in", OPT_IN)):
            if extra:   # the one-launch descent of the opt-in round
                os.environ[ttk.FUSED_DESCENT_ENV] = "1"
            args, fm, opt, _, one_round = build_round(extra + OBS_ON)
            per_round = (HEADLINE_PER_ROUND if not extra
                         else opt_in_per_round(fm, args))
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            for s in range(3):
                one_round(synthetic_batch(s))
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            assert counts == {k.name: 3 * per_round.get(k.name, 0)
                              for k in kernels.KERNELS}, (label, counts)
            planes[label] = metric_vector_check(label, fm, opt,
                                                synthetic_batch(3))
            out[f"{label} costs"] = reduction_costs(label, planes[label])
            del fm, opt, one_round, planes[label]
            torch.cuda.empty_cache()
            os.environ.pop(ttk.FUSED_DESCENT_ENV, None)
        _, fm, opt, _, one_round = build_gpt2(OBS_ON)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        for s in range(2):
            one_round(gpt2_batch(s))
        torch.cuda.synchronize()
        assert kernels.launch_counts() == {
            k.name: 2 * HEADLINE_PER_ROUND.get(k.name, 0)
            for k in kernels.KERNELS}
        gp = metric_vector_check("gpt2 f32", fm, opt, gpt2_batch(2))
        out["gpt2 f32 costs"] = reduction_costs("gpt2 f32", gp)
        del fm, opt, one_round, gp
        torch.cuda.empty_cache()

        # (2) on / off identity, (3) the strict audit
        obs_identity("headline", build_round,
                     [synthetic_batch(s) for s in range(4)])
        out["audit"] = obs_audit(tmp)

        # (4) poisoned rounds through the headline and the opt-in kernels
        out["ladder"] = {"headline": guard_ladder("headline", [])}
        os.environ[ttk.FUSED_DESCENT_ENV] = "1"
        out["ladder"]["opt-in"] = guard_ladder("opt-in", OPT_IN)
        del os.environ[ttk.FUSED_DESCENT_ENV]

        # (5) the CLI, (6) the cost pairs
        out["cli"] = obs_cli(tmp)
        out["costs"] = [
            obs_costs(card, "headline", build_round, synthetic_batch(),
                      HEADLINE_PER_ROUND, tmp),
            obs_costs(card, "gpt2 f32", build_gpt2, gpt2_batch(),
                      HEADLINE_PER_ROUND, tmp)]
    return out


# phase 13: client participation, stragglers and async buffering
PART_FAULTS = "drop=0.1,slow=0.2,corrupt=0.05,delay=2,seed=7"
PART_ON = ["--participation", "0.75", "--inject_client_fault", PART_FAULTS,
           "--staleness_decay", "0.5"]
PART_ASYNC = ["--async_buffer", "3"]
PART_ROUNDS = 20
PART_IDENTITY_ROUNDS = 10
PART_OPT_IN_ROUNDS = 8
PART_ASYNC_ROUNDS = 12
PART_RESUME_ROUNDS = 8
PART_GPT2_ROUNDS = 6
GPT2_SLOW = ["--inject_client_fault", "slow=0.25,delay=1,seed=7"]
# alternating on / off pairs of the cost step, and engine rounds a window
PART_PAIRS = {"headline": 4, "gpt2 f32": 1}
PART_PAIR_ROUNDS = {"headline": 20, "gpt2 f32": 8}
HEADLINE_CLIENT = {"sketch_accumulate": 1}
HEADLINE_SERVER = {"sketch_accumulate": 1, "sketch_estimates": 1,
                   "topk_count_ge": 8}


def part_batch(seed: int = 0):
    """A headline batch of a 0.75 cohort: 6 clients in the 8 slots and 2
    padded ones (zero masks), as the loader pads a short cohort."""
    b = synthetic_batch(seed)
    b["mask"][6:] = 0.0
    b["worker_mask"][6:] = 0.0
    b["client_ids"][6:] = 0
    return b


def attach_layer(args, fm):
    from commefficient_torch.federated.participation import (
        attach_participation,
    )

    ctl = attach_participation(args, fm)
    assert ctl is not None
    return ctl


def record_layer(ctl) -> dict:
    """Wrap the controller's ``apply_faults``, ``fold_due`` and
    ``async_step`` to record each dispatch's on-time and late worker
    masks, each synchronous fold's operands (the on-time table and count,
    the due cohorts, the folded table) and each async fold decision.
    Records only: no device value is read."""
    log = {"masks": [], "late": [], "folds": [], "fold": []}
    apply, fold_due, async_step = (ctl.apply_faults, ctl.fold_due,
                                   ctl.async_step)

    def rec_apply(batch, rnd):
        p, late, info = apply(batch, rnd)
        log["masks"].append(np.asarray(p["worker_mask"]).copy())
        log["late"].append(None if late is None
                           else np.asarray(late["worker_mask"]).copy())
        return p, late, info

    def rec_fold(ctx, rnd, sharded, count):
        due = [c for c in ctl.pending if c.due_round <= rnd]
        new, landed = fold_due(ctx, rnd, sharded, count)
        log["fold"].append(True)
        if due:
            log["folds"].append((ctx.gradient, count, due, rnd,
                                 new.gradient))
        return new, landed

    def rec_async(ctx, rnd, sharded, count, ids=None):
        out = async_step(ctx, rnd, sharded, count, ids)
        log["fold"].append(out[1])
        return out

    ctl.apply_faults, ctl.fold_due, ctl.async_step = (rec_apply, rec_fold,
                                                      rec_async)
    return log


def derived_launches(log, client: dict, server: dict) -> dict:
    """The launches the recorded dispatches must have made: ``client``
    for the on-time client phase and again for a straggler dispatch,
    ``server`` for each dispatch that ran its server phase."""
    want = {k.name: 0 for k in kernels.KERNELS}
    for late, fold in zip(log["late"], log["fold"]):
        for name, n in client.items():
            want[name] += n * (2 if late is not None else 1)
        if fold:
            for name, n in server.items():
                want[name] += n
    return want


def check_pattern(log, batches, label: str) -> None:
    """The card run's fault pattern is the one a CPU controller with the
    same schedule draws from the same batches."""
    from commefficient_torch.federated.participation import (
        ParticipationController,
        parse_client_fault,
    )

    spec = PART_FAULTS if label != "gpt2 f32" else GPT2_SLOW[1]
    cpu = ParticipationController(schedule=parse_client_fault(spec))
    for i, (mask, late) in enumerate(zip(log["masks"], log["late"])):
        p, lt, _ = cpu.apply_faults(batches[i], i)
        assert np.array_equal(p["worker_mask"], mask), (label, i)
        assert (lt is None) == (late is None), (label, i)
        if lt is not None:
            assert np.array_equal(lt["worker_mask"], late), (label, i)


def check_folds(log, decay: float, label: str) -> dict:
    """Each late landing's folded table against (S_now + w S_late) /
    (C_now + w C_late) computed in float64 from the held tensors: the
    largest difference at most 1e-6 of the table's largest magnitude."""
    worst = 0.0
    for g, count, due, rnd, got in log["folds"]:
        c = float(np.float32(count))
        num = g.double() * c
        den = c
        for coh in due:
            w = decay ** (rnd - coh.dispatch_round)
            num = num + w * coh.transmit_sum.double()
            den += w * coh.count
        want = num / den
        err = float((got.double() - want).abs().max()
                    / want.abs().max().clamp_min(1e-30))
        worst = max(worst, err)
    assert log["folds"], f"{label}: no straggler landed"
    assert worst <= 1e-6, f"{label}: late landing off by {worst:.3g}"
    return {"landings": len(log["folds"]), "max_rel_err": worst}


def part_engine(label, extra, batches, client, server, n, audit=True):
    """``n`` engine rounds (window 2, drain every 8) of the headline round
    plus ``extra`` with the layer attached and recorded, each non-drain
    submit under ``set_sync_debug_mode("error")`` (with ``audit``); the
    launches checked against the recorded pattern (``client``: a dict, or
    a function of the model and its args that gives one). Returns the
    model, optimizer, controller, log and audit."""
    args, fm, opt, sched, _ = build_round(extra)
    if callable(client):
        client = client(fm, args)
    ctl = attach_layer(args, fm)
    log = record_layer(ctl)
    eng = PipelinedRoundEngine(fm, opt, sched, window=2, drain_every=8)
    audit_ = {"audited": 0, "fetches": 0, "drains": 0}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    got = []
    for i in range(n):
        b = batches[i % len(batches)]
        got.extend(audited_submit(eng, b, audit_) if audit
                   else eng.submit(b))
    got.extend(eng.drain())
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = derived_launches(log, client, server)
    assert counts == want, f"{label}: launches {counts}, derived {want}"
    assert audit_["fetches"] == 0, f"{label}: fetches between drains"
    assert len(got) == n
    for r in got:
        assert np.all(np.isfinite(r.values[0])), f"{label}: loss"
    assert bool(torch.isfinite(fm.ps_weights).all()), f"{label}: weights"
    late = sum(x is not None for x in log["late"])
    print(f"{label}: {n} engine rounds, {late} straggler dispatches, "
          f"{sum(log['fold'])} server phases, launches as derived "
          + json.dumps({k: v for k, v in counts.items() if v}) + "; "
          f"{audit_['audited']} non-drain submits audited, "
          f"{audit_['fetches']} fetches; counters "
          + json.dumps(ctl.counters()))
    return fm, opt, ctl, log, audit_


def part_identity() -> None:
    """(1) The layer attached with nothing set (``--participation 1.0``):
    PART_IDENTITY_ROUNDS headline rounds bit-equal to the same rounds
    without the layer."""
    ws = []
    with deterministic_cudnn():
        for extra in ([], ["--participation", "1.0"]):
            args, fm, opt, _, one_round = build_round(extra)
            if extra:
                attach_layer(args, fm)
            for s in range(PART_IDENTITY_ROUNDS):
                one_round(synthetic_batch(s % 4))
            torch.cuda.synchronize()
            ws.append((fm.ps_weights, opt.server_state.velocity,
                       opt.server_state.error))
            del fm, opt, one_round
    for name, a, b in zip(("weights", "velocity", "error"), *ws):
        assert bit_equal(a, b), f"full participation: {name} differs"
    print(f"full participation: {PART_IDENTITY_ROUNDS} rounds with the "
          "layer attached bit-equal to the rounds without it")
    del ws
    torch.cuda.empty_cache()


def part_headline(card: str) -> dict:
    """(2) The headline under faults: PART_ROUNDS engine rounds, the
    pattern against a CPU controller's, the launches as derived, the late
    landings against the hand-computed fold, the strict audit, and one
    server step through the kernels and the plain versions."""
    batches = [part_batch(s) for s in range(4)]
    fm, opt, ctl, log, audit = part_engine(
        "headline faults", PART_ON, batches, HEADLINE_CLIENT,
        HEADLINE_SERVER, PART_ROUNDS)
    check_pattern(log, [batches[i % 4] for i in range(PART_ROUNDS)],
                  "headline")
    folds = check_folds(log, 0.5, "headline")
    table = log["folds"][-1][4]
    state, lr = opt.server_state, opt.get_lr()
    upd_k, st_k = server_update(table, state, fm.server_config, lr,
                                sketch=fm.sketch, layout=fm.layout)
    with plain_kernels():
        upd_p, st_p = server_update(table, state, fm.server_config, lr,
                                    sketch=fm.sketch, layout=fm.layout)
    torch.cuda.synchronize()
    for name, a, b in (("update", upd_k, upd_p),
                       ("velocity", st_k.velocity, st_p.velocity),
                       ("error", st_k.error, st_p.error)):
        # equal under ==: a zero median's sign is free
        assert nan_equal(a, b), f"folded server {name}: kernels != plain"
    out = {"phase": "participation", "leg": "headline faults",
           "rounds": PART_ROUNDS, **folds, "counters": ctl.counters(),
           "audited_submits": audit["audited"], "fetches": audit["fetches"],
           "card": card}
    print(json.dumps(out))
    del fm, opt, ctl, log, table
    torch.cuda.empty_cache()
    return out


def part_opt_in(card: str) -> dict:
    """(3) The opt-in round with stragglers: kernels 2, 3, 4, 6, launches
    as derived from the pattern and the coalescing plan."""
    def client(fm, args):
        per = opt_in_per_round(fm, args)
        return {"sketch_accumulate_into": per["sketch_accumulate_into"]}

    os.environ[ttk.FUSED_DESCENT_ENV] = "1"
    try:
        batches = [part_batch(s) for s in range(4)]
        fm, opt, ctl, log, _ = part_engine(
            "opt-in faults", OPT_IN + PART_ON, batches, client,
            {"sketch_estimates": 1, "topk_descent": 1, "fused_epilogue": 1},
            PART_OPT_IN_ROUNDS, audit=False)
        folds = check_folds(log, 0.5, "opt-in") if log["folds"] else {}
    finally:
        os.environ.pop(ttk.FUSED_DESCENT_ENV, None)
    out = {"phase": "participation", "leg": "opt-in faults",
           "rounds": PART_OPT_IN_ROUNDS, **folds,
           "counters": ctl.counters(), "card": card}
    print(json.dumps(out))
    del fm, opt, ctl, log
    torch.cuda.empty_cache()
    return out


def part_async(card: str) -> dict:
    """(4) ``--async_buffer 3`` at the headline: the launches as derived
    (a buffered dispatch launches the client sketch only), a NaN-poisoned
    buffered contribution masked out of its fold and counted, and a
    resume taken mid-buffer bit-equal to the continuous run."""
    batches = [part_batch(s) for s in range(4)]
    fm, opt, ctl, log, _ = part_engine(
        "async K=3", PART_ON + PART_ASYNC, batches, HEADLINE_CLIENT,
        HEADLINE_SERVER, PART_ASYNC_ROUNDS)
    buffered = len(log["fold"]) - sum(log["fold"])
    assert buffered and sum(log["fold"]), log["fold"]
    out = {"phase": "participation", "leg": "async K=3",
           "rounds": PART_ASYNC_ROUNDS, "buffered_dispatches": buffered,
           "counters": ctl.counters()}
    del fm, opt, ctl, log
    # dispatch 0 is buffered (the buffer starts empty), its transmit
    # poisoned with NaN: the fold masks it
    fm, opt, ctl, log, _ = part_engine(
        "async poisoned", PART_ON + PART_ASYNC + ["--inject_fault", "0:nan"],
        batches, HEADLINE_CLIENT, HEADLINE_SERVER, 6, audit=False)
    assert not log["fold"][0] and ctl.masked == 1, ctl.counters()
    out["poisoned"] = ctl.counters()
    del fm, opt, ctl, log

    with deterministic_cudnn():
        argv = PART_ON + PART_ASYNC
        args_a, fa, oa, sa, one_a = build_round(argv)
        attach_layer(args_a, fa)
        for i in range(PART_RESUME_ROUNDS):
            one_a(batches[i % 4])
        args, fb, ob, sb, one_b = build_round(argv)
        cb = attach_layer(args, fb)
        done = 0
        while done < 3 or not cb.buffer:
            one_b(batches[done % 4])
            done += 1
        assert done < PART_RESUME_ROUNDS, "no mid-buffer point"
        sampler = {"permuted": np.arange(64, dtype=np.int64),
                   "cursor": np.zeros(64, np.int64)}
        with tempfile.TemporaryDirectory() as tmp:
            args.checkpoint_path = tmp
            path = save_round_state(args, 0, done, sampler, fb, ob, sb,
                                    (0.0, 0.0))
            held = len(cb.buffer) + len(cb.pending)
            del fb, ob, sb, one_b, cb
            args_c, fc, oc, sc, one_c = build_round(argv)
            attach_layer(args_c, fc)
            load_run_state(path, fc, oc, sc)
        for i in range(done, PART_RESUME_ROUNDS):
            one_c(batches[i % 4])
        torch.cuda.synchronize()
        for name, a, b in (("weights", fc.ps_weights, fa.ps_weights),
                           ("velocity", oc.server_state.velocity,
                            oa.server_state.velocity),
                           ("error", oc.server_state.error,
                            oa.server_state.error)):
            assert bit_equal(a, b), f"async resume: {name} differs"
    print(f"async resume after {done} dispatches ({held} contributions "
          f"held): {PART_RESUME_ROUNDS} dispatches bit-equal to the "
          "continuous run")
    out.update(resume_at=done, resume_held=held, card=card)
    print(json.dumps(out))
    del fa, oa, fc, oc
    torch.cuda.empty_cache()
    return out


def part_gpt2(card: str) -> dict:
    """(5) GPT-2-small float32 with ``slow=0.25`` (delay 1): launches as
    derived, tokens/sec and peak memory of the timed rounds, and the held
    sum is the (r, c_pad) table, not a d-sized tensor."""
    args, fm, opt, sched, one_round = build_gpt2(GPT2_SLOW)
    ctl = attach_layer(args, fm)
    log = record_layer(ctl)
    batch = gpt2_batch()
    for _ in range(2):
        one_round(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    held = None
    for _ in range(PART_GPT2_ROUNDS):
        one_round(batch)
        if ctl.pending:
            held = ctl.pending[-1].transmit_sum
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    timed = {k: v[2:] for k, v in log.items() if k in ("late", "fold")}
    want = derived_launches(timed, HEADLINE_CLIENT, HEADLINE_SERVER)
    assert counts == want, f"gpt2 slow: launches {counts}, derived {want}"
    check_pattern(log, [batch] * (2 + PART_GPT2_ROUNDS), "gpt2 f32")
    assert held is not None, "gpt2 slow: no straggler held"
    assert tuple(held.shape) == tuple(fm.sketch.table_shape), held.shape
    assert held.numel() < fm.grad_size // 20
    tokens = GPT2_W * GPT2_B * GPT2_C * GPT2_T
    rps = PART_GPT2_ROUNDS / wall
    out = {"phase": "participation", "leg": "gpt2 f32 slow=0.25",
           "rounds": PART_GPT2_ROUNDS, "tokens_per_round": tokens,
           "tokens_per_sec": rps * tokens,
           "straggler_dispatches": sum(x is not None
                                       for x in timed["late"]),
           "peak_memory_GB": torch.cuda.max_memory_allocated() / 1e9,
           "held_shape": list(held.shape), "d": fm.grad_size,
           "counters": ctl.counters(), "card": card}
    print(json.dumps(out))
    del fm, opt, sched, one_round, ctl, held, log
    torch.cuda.empty_cache()
    return out


def straggler_device_ms(fm, late_batch, n: int = 3) -> float:
    """Device ms of one straggler dispatch (its client phase) under
    ``torch.profiler``."""
    from commefficient_torch.federated.aggregator import _to_device

    staged = []   # the pinned buffers, kept until the copies ran
    dlate = _to_device(late_batch, fm.device, staged)
    rows, _ = device_rows(lambda: fm.steps.client_step(
        fm.ps_weights, fm.client_states, fm._model_state, dlate,
        fm._opt_lr, fm._rng), n)
    del staged
    return sum(dev_us(e) for e in rows) / 1e3 / n


def part_costs(card: str, label: str, build, on, batch) -> dict:
    """(6) Rounds/sec with the layer on (``on``) against off through the
    engine, in PART_PAIRS[label] alternating pairs of
    PART_PAIR_ROUNDS[label] rounds, and the device ms of one straggler
    dispatch. Data: no exit code depends on a ratio."""
    engines = {}
    for cfg, extra in (("off", []), ("on", on)):
        args, fm, opt, sched, _ = build(extra)
        if cfg == "on":
            attach_layer(args, fm)
        engines[cfg] = PipelinedRoundEngine(fm, opt, sched, window=2,
                                            drain_every=8)
        for _ in range(3):
            engines[cfg].submit(batch)
        engines[cfg].drain()
    n = PART_PAIR_ROUNDS[label]

    def run(cfg):
        eng = engines[cfg]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            eng.submit(batch)
        eng.drain()
        torch.cuda.synchronize()
        return n / (time.perf_counter() - t0)

    rps = {"off": [], "on": []}
    ratios = []
    for p in range(PART_PAIRS[label]):
        order = ("off", "on") if p % 2 == 0 else ("on", "off")
        r = {c: run(c) for c in order}
        for c, v in r.items():
            rps[c].append(v)
        ratios.append(r["on"] / r["off"])
    fm_on = engines["on"].model
    late = dict(batch)
    wm = np.zeros_like(batch["worker_mask"])
    wm[:2] = 1.0
    late["worker_mask"] = wm
    late["mask"] = (batch["mask"] * wm.reshape(
        (-1,) + (1,) * (batch["mask"].ndim - 1))).astype(np.float32)
    strag_ms = straggler_device_ms(fm_on, late)
    ctl = fm_on._participation
    row = {"phase": "participation", "leg": f"{label} cost",
           "pairs": PART_PAIRS[label], "rounds_per_window": n,
           "rounds_per_sec": rps,
           "on_off_ratio": {"median": statistics.median(ratios),
                            "min": min(ratios), "max": max(ratios),
                            "all": ratios},
           "straggler_dispatch_device_ms": strag_ms,
           "counters_on": ctl.counters(), "card": card}
    if label.startswith("gpt2"):
        tokens = GPT2_W * GPT2_B * GPT2_C * GPT2_T
        row["tokens_per_sec"] = {c: [v * tokens for v in vs]
                                 for c, vs in rps.items()}
    print(json.dumps(row))
    print(f"{label} participation on / off: median "
          f"{statistics.median(ratios):.4f} (spread {min(ratios):.4f}-"
          f"{max(ratios):.4f}), straggler dispatch {strag_ms:.3f} device "
          f"ms ({card}; data, not a gate)")
    del engines, fm_on
    torch.cuda.empty_cache()
    return row


def phase_participation(card: str) -> dict:
    """Phase 13: client participation, stragglers and async buffering at
    full width."""
    out = {}
    part_identity()
    out["headline"] = part_headline(card)
    out["opt-in"] = part_opt_in(card)
    out["async"] = part_async(card)
    out["gpt2"] = part_gpt2(card)
    out["costs"] = [
        part_costs(card, "headline", build_round, PART_ON, part_batch()),
        part_costs(card, "gpt2 f32", build_gpt2, GPT2_SLOW, gpt2_batch())]
    return out


# phase 14: per-client state off the card
OFF_BASE = ["--mode", "sketch", "--error_type", "local",
            "--local_momentum", "0.9", "--virtual_momentum", "0",
            "--num_rows", "5", "--num_cols", "500000", "--k", "50000",
            "--num_workers", "8", "--local_batch_size", "8",
            "--dataset_name", "CIFAR10", "--device", "cuda",
            "--no_telemetry", "--seed", "0"]
OFF_TOPK = ["--mode", "local_topk", "--error_type", "local",
            "--local_momentum", "0.9", "--virtual_momentum", "0",
            "--k", "50000", "--num_workers", "8", "--local_batch_size", "8",
            "--dataset_name", "CIFAR10", "--device", "cuda",
            "--no_telemetry", "--seed", "0"]
# kernels 1 / 3 / 5 a sketch-local round: 8 client tables, the re-sketch
# and the keep mask's re-sketch; one query; 8 count passes. Local top-k:
# 8 count passes in each of the 8 slots
OFF_PER_ROUND = {"sketch_accumulate": 10, "sketch_estimates": 1,
                 "topk_count_ge": 8}
OFF_TOPK_PER_ROUND = {"topk_count_ge": 64}
_BIG = str(2 ** 62)
OFF_TIERS = {"hbm": {"COMMEFFICIENT_STATE_HBM_BUDGET": _BIG},
             "host": {"COMMEFFICIENT_STATE_HBM_BUDGET": "1",
                      "COMMEFFICIENT_STATE_HOST_BUDGET": _BIG},
             "disk": {"COMMEFFICIENT_STATE_HBM_BUDGET": "1",
                      "COMMEFFICIENT_STATE_HOST_BUDGET": "1"}}
OFF_IDENTITY_CLIENTS = 64
OFF_IDENTITY_ROUNDS = 10
OFF_PART_ROUNDS = 6
OFF_EMNIST = 3500
OFF_POP_ROUNDS = 20
OFF_POP_PAIRS = 1
OFF_LARGE = 100_000
OFF_LARGE_ROUNDS = 8
OFF_TOPK_ROUNDS = 5
OFF_IO_FAULT = "eio=0.02,short=0.01,torn=0.01,seed=3"
OFF_FLIP = "flip=0.01,seed=5"
RESNET9_D = 6_568_640


def off_batch(seed: int, n_clients: int, live: int = 8):
    """A round of 8 slots at a population of ``n_clients``: ``live``
    clients drawn without replacement, the rest padding (client 0, zero
    masks), as the loader pads a short cohort."""
    rng = np.random.RandomState(1000 + seed)
    b = {"inputs": rng.randn(8, 8, 32, 32, 3).astype(np.float32),
         "targets": rng.randint(0, 10, size=(8, 8)).astype(np.int64),
         "mask": np.ones((8, 8), np.float32),
         "client_ids": rng.choice(n_clients, 8, replace=False)
         .astype(np.int32),
         "worker_mask": np.ones(8, np.float32)}
    b["mask"][live:] = 0.0
    b["worker_mask"][live:] = 0.0
    b["client_ids"][live:] = 0
    return b


def build_offload(extra, num_clients: int, env: dict, state_dir: str,
                  base=OFF_BASE, prefetch: bool = True):
    """FedModel / FedOptimizer / LambdaLR (constant lr 0.1) at full width
    with the tier the plan resolves under ``env`` (the budget overrides;
    empty: the planner's own probes) and the disk tier in ``state_dir``."""
    env = dict(env, COMMEFFICIENT_COHORT_PREFETCH="1" if prefetch else "0")
    with env_vars(**env):
        args = parse_args(argv=base + list(extra) + [
            "--num_clients", str(num_clients), "--state_dir", state_dir])
        model = ResNet9()
        train_loss, val_loss = make_cv_losses(model)
        fm = FedModel(model, train_loss, args, val_loss,
                      num_clients=num_clients)
    opt = FedOptimizer(fm, args)
    sched = LambdaLR(opt, lambda step: 0.1)
    return args, fm, opt, sched


def off_engine(fm, opt, sched, batches, audit=None, offloads=None):
    """The batches through ``PipelinedRoundEngine(window=2,
    drain_every=8)`` and ``cohort_lookahead`` (the prefetcher's path);
    non-drain submits audited when ``audit`` is a dict; each round's
    ``offload`` record appended to ``offloads``."""
    from commefficient_torch.federated.engine import cohort_lookahead

    if offloads is not None:
        seal = fm.seal_round

        def recording_seal(h):
            h = seal(h)
            offloads.append(h.offload)
            return h

        fm.seal_round = recording_seal
    eng = PipelinedRoundEngine(fm, opt, sched, window=2, drain_every=8)
    got = []
    for b in cohort_lookahead(batches, fm):
        got.extend(audited_submit(eng, b, audit) if audit is not None
                   else eng.submit(b))
    got.extend(eng.drain())
    if offloads is not None:
        del fm.seal_round
    for r in got:
        assert np.all(np.isfinite(r.values[0])), "offload: non-finite loss"
    return got


def rows_of(fm, ids) -> dict:
    """The client rows of ``ids`` on the card, read from the model's tier
    after a drain of its worker."""
    ids = np.unique(np.asarray(ids, np.int64))
    fm.drain_client_state()
    if fm._row_store is not None:
        s = fm._row_store.gather(ids)
        s.wait_ready()
        return {m: getattr(s.proxy, m).clone()
                for m in fm._row_store.row_shapes}
    if fm._row_stream is not None:
        idx = torch.from_numpy(ids)
        return {m: a[idx].to(fm.device) for m, a in
                fm._row_stream.arrays.items()}
    cs = fm.client_states
    idx = torch.from_numpy(ids).to(fm.device)
    return {m: getattr(cs, m)[idx].clone()
            for m in ("velocities", "errors", "weights")
            if getattr(cs, m) is not None}


def check_launches(label: str, per_round: dict, n: int) -> dict:
    counts = kernels.launch_counts()
    want = {k.name: per_round.get(k.name, 0) * n for k in kernels.KERNELS}
    assert counts == want, f"{label}: launches {counts}, expected {want}"
    return {k: v // n for k, v in counts.items() if v}


def same_state(label: str, a, b) -> None:
    (wa, ra), (wb, rb) = a, b
    assert bit_equal(wa, wb), f"{label}: weights differ"
    assert sorted(ra) == sorted(rb), f"{label}: members differ"
    for m in ra:
        assert bit_equal(ra[m], rb[m]), f"{label}: {m} rows differ"


def mem_status() -> dict:
    """The process's resident set now (``/proc/self/status`` VmRSS) and
    its peak over the process's life (``getrusage`` ru_maxrss), GiB."""
    import resource

    out = {"peak": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
           * 1024 / 2 ** 30}
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                out["now"] = int(line.split()[1]) * 1024 / 2 ** 30
    return out


def fs_used(path: str) -> int:
    """Bytes in use on the filesystem that holds ``path``
    (``statvfs``)."""
    st = os.statvfs(path)
    return (st.f_blocks - st.f_bfree) * st.f_frsize


def off_identity(tmp: str) -> dict:
    """(1) Sketch-local at 64 clients: 10 engine rounds in each tier, with
    prefetch on and off, bit-equal (weights and every touched row);
    kernels 1 / 3 / 5 at 10 / 1 / 8 a round in each; every non-drain
    submit under the strict audit with no fetch. Then 0.75 cohorts under
    client faults on the disk tier against the hbm tier."""
    n = OFF_IDENTITY_CLIENTS
    batches = [off_batch(s, n) for s in range(OFF_IDENTITY_ROUNDS)]
    ids = np.concatenate([b["client_ids"] for b in batches])
    res, pf_counts = {}, {}
    with deterministic_cudnn():
        for tier in ("hbm", "host", "disk"):
            for pf in (True, False):
                d = tempfile.mkdtemp(dir=tmp)
                _, fm, opt, sched = build_offload([], n, OFF_TIERS[tier],
                                                  d, prefetch=pf)
                assert fm.memory_plan.placement == tier, \
                    fm.memory_plan.placement
                audit = {"audited": 0, "fetches": 0, "drains": 0}
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                off_engine(fm, opt, sched, batches, audit)
                torch.cuda.synchronize()
                per = check_launches(f"offload {tier}", OFF_PER_ROUND,
                                     OFF_IDENTITY_ROUNDS)
                assert audit["fetches"] == 0, f"{tier}: fetches"
                res[(tier, pf)] = (fm.ps_weights.clone(), rows_of(fm, ids))
                pf_counts[f"{tier} prefetch {'on' if pf else 'off'}"] = (
                    fm._prefetcher.counters() if fm._prefetcher else None)
                fm.finalize()
                del fm, opt, sched
                shutil.rmtree(d)
        ref = res[("hbm", True)]
        for key, val in res.items():
            same_state(f"offload identity {key}", val, ref)
        touched = len(np.unique(ids))
        print(f"offload identity: {OFF_IDENTITY_ROUNDS} sketch-local "
              f"rounds at {n} clients bit-equal over hbm / host / disk with "
              f"prefetch on and off (weights and {touched} touched rows x "
              f"2 members); launches per round " + json.dumps(per)
              + " in every tier; strict audit: 0 fetches; prefetch "
              + json.dumps(pf_counts))
        del res
        torch.cuda.empty_cache()
        # a 0.75 cohort (6 of 8 slots) under client faults
        part = [off_batch(s, n, live=6) for s in range(OFF_PART_ROUNDS)]
        pids = np.concatenate([b["client_ids"] for b in part])
        states = {}
        for tier in ("hbm", "disk"):
            d = tempfile.mkdtemp(dir=tmp)
            args, fm, opt, sched = build_offload(PART_ON, n,
                                                 OFF_TIERS[tier], d)
            ctl = attach_layer(args, fm)
            off_engine(fm, opt, sched, part)
            states[tier] = ((fm.ps_weights.clone(), rows_of(fm, pids)),
                            ctl.counters())
            fm.finalize()
            del fm, opt, sched
            shutil.rmtree(d)
        same_state("offload participation disk vs hbm", states["disk"][0],
                   states["hbm"][0])
        assert states["disk"][1] == states["hbm"][1]
        print(f"offload participation: {OFF_PART_ROUNDS} rounds of 0.75 "
              f"cohorts under {PART_FAULTS} on the disk tier bit-equal to "
              f"the hbm tier; counters " + json.dumps(states["disk"][1]))
    return {"prefetch": pf_counts}


def off_population(card: str, tmp: str) -> dict:
    """(2) The EMNIST population, sketch-local: the plan from the
    planner's own probes, then the host tier (at 3,500 clients if the
    planner puts them there, else at the largest population in steps of
    500 that it places in host with only the device budget forced)
    against the hbm tier forced at the same population, in OFF_POP_PAIRS
    pair(s) of 20 engine rounds (host first, then alternating)."""
    from commefficient_torch.federated import memory as fmem

    mem_total = None
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                mem_total = int(line.split()[1]) * 1024
    args = parse_args(argv=OFF_BASE + ["--num_clients", str(OFF_EMNIST)])
    from commefficient_torch.federated.aggregator import (
        worker_config_from_args,
    )

    wcfg = worker_config_from_args(args)
    dev = torch.device(args.device)
    sk = tsk.make_sketch(RESNET9_D, args.num_cols, args.num_rows, seed=0,
                         num_blocks=args.num_blocks, device=dev)

    def plan(n, **kw):
        return fmem.plan_client_state_memory(n, RESNET9_D, wcfg, sketch=sk,
                                             device=dev, **kw)

    p = plan(OFF_EMNIST)
    # the budgets the planner used: the probes, unless overridden
    hbm_b = int(os.environ.get("COMMEFFICIENT_STATE_HBM_BUDGET")
                or fmem._device_hbm_budget(dev))
    host_b = int(os.environ.get("COMMEFFICIENT_STATE_HOST_BUDGET")
                 or fmem._host_ram_budget())
    print(f"offload plan at {OFF_EMNIST} clients (probes: device budget "
          f"{hbm_b / 2**30:.2f} GiB = half of "
          f"{torch.cuda.mem_get_info()[1] / 2**30:.2f} GiB, host budget "
          f"{host_b / 2**30:.2f} GiB = half of MemTotal "
          f"{mem_total / 2**30:.2f} GiB): {p.summary()}; row "
          f"{p.row_bytes:,} B")
    # two members of r x c_pad float32 a client: 70,013,440,000 B
    assert p.total_bytes == 2 * OFF_EMNIST * sk.r * sk.c_pad * 4, \
        p.total_bytes
    if p.placement == "host":
        n, env_host = OFF_EMNIST, {}
        why = "the planner places the EMNIST population in host"
    elif plan(OFF_EMNIST, hbm_budget_bytes=1).placement == "host":
        n, env_host = OFF_EMNIST, {"COMMEFFICIENT_STATE_HBM_BUDGET": "1"}
        why = ("the planner keeps the EMNIST population on the card; the "
               "host leg forces the device budget to 1 B")
    else:
        n = max(k for k in range(500, OFF_EMNIST + 1, 500)
                if plan(k, hbm_budget_bytes=1).placement == "host")
        env_host = {"COMMEFFICIENT_STATE_HBM_BUDGET": "1"}
        why = (f"the planner resolves {p.placement} at {OFF_EMNIST} clients "
               f"({p.total_bytes / 2**30:.2f} GiB > the host budget "
               f"{host_b / 2**30:.2f} GiB); the host leg runs at {n} "
               f"clients ({plan(n).total_bytes / 2**30:.2f} GiB), the "
               f"largest multiple of 500 it places in host with the device "
               f"budget forced to 1 B")
    print("offload population: " + why)
    batches = [off_batch(s, n) for s in range(OFF_POP_ROUNDS)]
    models = {}
    for tier, env in (("host", env_host), ("hbm", OFF_TIERS["hbm"])):
        models[tier] = build_offload([], n, env,
                                     tempfile.mkdtemp(dir=tmp))
        assert models[tier][1].memory_plan.placement == tier
        off_engine(*models[tier][1:], [off_batch(90 + s, n)
                                       for s in range(2)])
    rps = {"host": [], "hbm": []}
    peak_dev, rss = {"host": [], "hbm": []}, {"host": [], "hbm": []}
    above = {"host": [], "hbm": []}
    host_off = []  # the host tier's offload records (its waits and adds)
    for p_ in range(OFF_POP_PAIRS):
        for tier in (("host", "hbm") if p_ % 2 == 0 else ("hbm", "host")):
            _, fm, opt, sched = models[tier]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            off_engine(fm, opt, sched, batches,
                       offloads=host_off if tier == "host" else None)
            torch.cuda.synchronize()
            rps[tier].append(OFF_POP_ROUNDS / (time.perf_counter() - t0))
            check_launches(f"offload population {tier}", OFF_PER_ROUND,
                           OFF_POP_ROUNDS)
            peak = torch.cuda.max_memory_allocated()
            peak_dev[tier].append(peak / 2**30)
            above[tier].append((peak - start) / 2**30)
            rss[tier].append(mem_status())
    row = {"phase": "offload", "leg": "population", "clients": n,
           "state_GiB": plan(n).total_bytes / 2**30,
           "planner_at_3500": p.placement, "why": why,
           "mem_total_GiB": mem_total / 2**30,
           "device_budget_GiB": hbm_b / 2**30,
           "host_budget_GiB": host_b / 2**30,
           "rounds_per_window": OFF_POP_ROUNDS, "pairs": OFF_POP_PAIRS,
           "rounds_per_sec": rps,
           # both models stay alive for the pairs: the process's peak
           # holds the hbm tier's state either way; above the window's
           # start is the round's own working set
           "peak_device_GiB": peak_dev, "window_peak_above_start_GiB": above,
           "state_on_card_GiB": {
               t: (plan(n).total_bytes / 2**30
                   if models[t][1].memory_plan.placement == "hbm" else 0.0)
               for t in models},
           "rss_GiB": rss,
           "host_gather_wait_ms": [o["gather_ms"] for o in host_off],
           "host_scatter_dispatch_ms": [o["scatter_ms"] for o in host_off],
           "host_worker_last_ms": {
               "gather": models["host"][1]._row_stream.last_gather_ms,
               "scatter": models["host"][1]._row_stream.last_scatter_ms},
           "card": card}
    print(json.dumps(row))
    print(f"offload population ({n} clients, sketch-local): host tier "
          f"{statistics.median(rps['host']):.3f} rounds/sec against hbm "
          f"{statistics.median(rps['hbm']):.3f} ({card}); a window's "
          f"device peak above its start {max(above['host']):.2f} / "
          f"{max(above['hbm']):.2f} GiB")
    for tier in models:
        models[tier][1].finalize()
    del models
    torch.cuda.empty_cache()
    return row


def off_large(card: str, tmp: str) -> dict:
    """(3) 10^5 clients, sketch-local, on the disk tier the planner picks:
    OFF_LARGE_ROUNDS timed rounds with a run state saved halfway; the prefetch
    hit share, gather_io_ms and scatter_io_ms, the blocks allocated in the
    row files against the rows touched (``st_blocks``, or the
    filesystem's own use where ``st_blocks`` reports the logical size),
    the resident set; a resume from the halfway save, with one byte of a
    row flipped on disk after the snapshot (detected and repaired from
    it), bit-exact at the last round; an injected EIO / short / torn drill
    over the second half bit-identical to the clean run; a flip drill with a scrub
    whose detections, repairs and watch alerts land in the event log."""
    n = OFF_LARGE
    half = OFF_LARGE_ROUNDS // 2
    batches = [off_batch(s, n) for s in range(OFF_LARGE_ROUNDS)]
    ids = np.concatenate([b["client_ids"] for b in batches])
    ck = os.path.join(tmp, "ck")
    out = {}
    with deterministic_cudnn():
        d = tempfile.mkdtemp(dir=tmp)
        rss0 = mem_status()
        used0 = fs_used(d)
        args, fm, opt, sched = build_offload([], n, {}, d)
        plan = fm.memory_plan
        assert plan.placement == "disk", plan.placement
        print(f"offload 10^5: {plan.summary()}")
        offloads, wall = [], 0.0
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        for first, part in ((True, batches[:half]),
                            (False, batches[half:])):
            t0 = time.perf_counter()
            off_engine(fm, opt, sched, part, offloads=offloads)
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
            if first:
                path = save_round_state(
                    argparse.Namespace(checkpoint_path=ck,
                                       keep_checkpoints=0),
                    0, half, {"permuted": np.arange(8, dtype=np.int64),
                              "cursor": np.zeros(n, np.int64)},
                    fm, opt, sched, (0.0, 0.0))
        per = check_launches("offload 10^5", OFF_PER_ROUND,
                             OFF_LARGE_ROUNDS)
        fm.drain_client_state()
        rss1 = mem_status()
        st = fm._row_store
        blocks = {}
        touched = np.unique(ids)
        used = fs_used(d) - used0
        for m in st.row_shapes:
            nb = st._row_nbytes[m]
            pages = set()
            for r in map(int, touched):
                pages.update(range(r * nb // 4096,
                                   -(-(r + 1) * nb // 4096)))
            stt = os.stat(st.member_path(m))
            got = stt.st_blocks * 512
            blocks[m] = {"st_blocks_bytes": got, "st_size": stt.st_size,
                         "rows_x_row_bytes": len(touched) * nb,
                         "pages_bytes": len(pages) * 4096}
            if got < stt.st_size:
                # the filesystem reports a sparse file's allocation
                assert len(touched) * nb <= got <= len(pages) * 4096 \
                    + (8 << 20), (m, blocks[m])
        want = sum(b["pages_bytes"] for b in blocks.values())
        truthful = all(b["st_blocks_bytes"] < b["st_size"]
                       for b in blocks.values())
        blocks["filesystem_used_delta"] = used
        blocks["st_blocks_reports_allocation"] = truthful
        # where st_blocks reports the logical size, the filesystem's own
        # use (statvfs) must still be of the rows touched, not of the
        # population
        assert used <= 4 * want + (1 << 30), (used, want)
        hits = sum(o["prefetch"] == "hit" for o in offloads)
        ref = (fm.ps_weights.clone(), rows_of(fm, ids))
        row = {"phase": "offload", "leg": "10^5 disk", "clients": n,
               "logical_TB": plan.total_bytes / 1e12,
               "rounds": OFF_LARGE_ROUNDS,
               "rounds_per_sec": OFF_LARGE_ROUNDS / wall,
               "launches_per_round": per,
               "prefetch_hit_share": hits / len(offloads),
               "gather_ms": [o["gather_ms"] for o in offloads],
               "gather_io_ms": [o["gather_io_ms"] for o in offloads],
               "scatter_io_ms": [o["scatter_io_ms"] for o in offloads],
               "blocks": blocks, "touched_rows": int(len(touched)),
               "rss_GiB_before": rss0, "rss_GiB_after": rss1,
               "card": card}
        # the W-row working set, not the population, is what is resident
        assert rss1["now"] - rss0["now"] < 8.0, (rss0, rss1)
        print(json.dumps(row))
        out["large"] = row
        fm.finalize()
        del fm, opt, sched
        shutil.rmtree(d)

        def resumed(label, extra=(), corrupt=False):
            """A new model restored from the halfway run state runs the
            second half (under ``extra``); with ``corrupt``, one byte of
            a row that its first round reads is flipped on disk first."""
            dd = tempfile.mkdtemp(dir=tmp)
            a, fm2, opt2, sched2 = build_offload(extra, n, {}, dd)
            load_run_state(path, fm2, opt2, sched2)
            if corrupt:
                # a row of the snapshot, clean since the restore
                row = int(batches[half]["client_ids"][0])
                s2 = fm2._row_store
                nb = s2._row_nbytes["errors"]
                fd = s2._fd["errors"]
                b = bytearray(os.pread(fd, 1, row * nb + 12345))
                b[0] ^= 0x5A
                os.pwrite(fd, bytes(b), row * nb + 12345)
            off_engine(fm2, opt2, sched2, batches[half:])
            same_state(label, (fm2.ps_weights.clone(), rows_of(fm2, ids)),
                       ref)
            c = fm2._row_store.io_counters()
            fm2.finalize()
            shutil.rmtree(dd)
            return c

        c = resumed("offload 10^5 resume", corrupt=True)
        assert c["corrupt"] >= 1 and c["repaired"] >= 1 \
            and c["quarantined"] == 0, c
        print(f"offload 10^5: run state saved after round {half} "
              f"({path}, .rows beside it); resumed with one byte of a row "
              f"flipped on disk after the snapshot, detected and repaired "
              f"from it: rounds {half + 1}-{OFF_LARGE_ROUNDS} bit-exact "
              f"(weights and all {len(np.unique(ids))} touched rows); "
              f"counters " + json.dumps(c))
        # the injected transient drill over the second half
        c3 = resumed("offload 10^5 EIO drill",
                     ["--inject_io_fault", OFF_IO_FAULT])
        assert c3["retries"] > 0 and c3["quarantined"] == 0, c3
        print(f"offload 10^5: --inject_io_fault {OFF_IO_FAULT} over rounds "
              f"{half + 1}-{OFF_LARGE_ROUNDS} bit-identical to the clean "
              f"run; counters " + json.dumps(c3))
        # the silent-corruption drill with a scrub and the watch plane
        dd = tempfile.mkdtemp(dir=tmp)
        _, fm4, opt4, sched4 = build_offload(
            ["--inject_io_fault", OFF_FLIP, "--io_scrub_rows", "8",
             "--telemetry"], n, {}, dd)
        log = os.path.join(dd, "telemetry.jsonl")
        rt = attach_recorder(fm4, log)
        off_engine(fm4, opt4, sched4, batches[:half])
        c4 = fm4._row_store.io_counters()
        from commefficient_torch.telemetry import close_run_telemetry

        close_run_telemetry(fm4, rt)
        fm4.finalize()
        events = list(read_events(log))
        alerts = sorted({e.get("rule", "") for e in events
                         if e.get("ev") == "watch_alert"})
        kinds = sorted({e["ev"] for e in events
                        if e["ev"].startswith(("row_", "io_"))})
        assert c4["corrupt"] > 0 and c4["repaired"] > 0, c4
        assert any("io_corrupt" in a for a in alerts), alerts
        print(f"offload 10^5: {OFF_FLIP} with --io_scrub_rows 8 over "
              f"{half} rounds: counters " + json.dumps(c4) + "; events "
              + json.dumps(kinds) + "; watch alerts " + json.dumps(alerts))
        out["flip"] = {"counters": c4, "alerts": alerts}
        shutil.rmtree(dd)
    return out


def off_topk(card: str, tmp: str) -> dict:
    """(4) Local top-k with dense local error and momentum at 3,500
    clients (183.9 GB): the tier the planner resolves, 5 rounds, 64 count
    passes a round."""
    d = tempfile.mkdtemp(dir=tmp)
    _, fm, opt, sched = build_offload([], OFF_EMNIST, {}, d, base=OFF_TOPK)
    plan = fm.memory_plan
    # two dense members of d float32 a client: 183,921,920,000 B
    assert plan.total_bytes == 2 * OFF_EMNIST * fm.grad_size * 4, \
        plan.total_bytes
    print(f"offload local top-k: {plan.summary()}")
    off_engine(fm, opt, sched, [off_batch(50, OFF_EMNIST)])
    offloads = []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    off_engine(fm, opt, sched, [off_batch(60 + s, OFF_EMNIST)
                                for s in range(OFF_TOPK_ROUNDS)],
               offloads=offloads)
    torch.cuda.synchronize()
    rps = OFF_TOPK_ROUNDS / (time.perf_counter() - t0)
    per = check_launches("offload local top-k", OFF_TOPK_PER_ROUND,
                         OFF_TOPK_ROUNDS)
    row = {"phase": "offload", "leg": "local top-k", "clients": OFF_EMNIST,
           "state_GB": plan.total_bytes / 1e9, "tier": plan.placement,
           "rounds_per_sec": rps, "launches_per_round": per,
           "offload": offloads, "card": card}
    print(json.dumps(row))
    fm.finalize()
    shutil.rmtree(d)
    return row


def phase_offload(card: str) -> dict:
    """Phase 14: per-client state off the card at ResNet9's full width."""
    tmp = tempfile.mkdtemp(prefix="offload_")
    out, wall = {}, {}
    try:
        for name, leg in (("identity", lambda: off_identity(tmp)),
                          ("population", lambda: off_population(card, tmp)),
                          ("large", lambda: off_large(card, tmp)),
                          ("topk", lambda: off_topk(card, tmp))):
            t = time.perf_counter()
            got = leg()
            if name == "large":
                out.update(got)
            else:
                out[name] = got
            wall[name] = round(time.perf_counter() - t, 2)
            print(f"offload leg wall seconds: {json.dumps(wall)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# phase 15: the open-world service
_HERE = os.path.dirname(os.path.abspath(__file__))
# the leg A headline: the phase-4 round with telemetry on, 200 iid clients
# under churn, a run state every 5 rounds with 2 kept
SERVICE_A = [a for a in HEADLINE if a != "--no_telemetry"] + [
    "--iid", "--num_clients", "200", "--num_epochs", "1", "--seed", "0",
    "--lr_scale", "0.1", "--pivot_epoch", "0.5",
    "--train_dataloader_workers", "0",
    "--churn", "join=2,depart=1.5,init=0.5,seed=3",
    "--checkpoint", "--checkpoint_every_rounds", "5",
    "--keep_checkpoints", "2"]
SERVICE_A_PER_CLASS = 160       # 1,600 images: 26 rounds of 64 (>= 20)
SERVICE_KILL_SEED = 15
SERVICE_QUERY_S = 0.2
# leg B: phase 14's sketch-local round, 128 clients on disk, compaction
SERVICE_B = [a for a in OFF_BASE if a != "--no_telemetry"] + [
    "--iid", "--num_clients", "128", "--num_epochs", "1",
    "--lr_scale", "0.1", "--pivot_epoch", "0.5",
    "--train_dataloader_workers", "0",
    "--churn", "join=1,depart=0.7,init=0.6,seed=3,compact=4",
    "--checkpoint", "--checkpoint_every_rounds", "5"]
SERVICE_B_PER_CLASS = 96        # 960 images: 16 rounds of 64 (the leg needs a
# compaction before its second-to-last save: two, at this size)
# leg C: two tenants of 10 headline rounds
SERVICE_C = HEADLINE + ["--iid", "--num_clients", "16", "--num_epochs",
                        "1", "--seed", "0", "--lr_scale", "0.1",
                        "--pivot_epoch", "0.5", "--checkpoint"]
SERVICE_C_PER_CLASS = 64        # 640 images: 10 rounds of 64
# the children's sitecustomize: cuDNN held deterministic (the bit-equal
# resume needs it, as in phase 8), and the kernel launch counts written
# at a clean exit
_SITE = """import atexit, json, os
import torch
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
_out = os.environ.get("SMOKE_LAUNCH_COUNTS")
if _out:
    def _dump():
        from commefficient_torch import kernels
        with open(_out, "w") as f:
            json.dump(kernels.launch_counts(), f)
    atexit.register(_dump)
"""


def service_env(tmp: str, **extra) -> dict:
    """The environment of a phase-15 child: the sitecustomize above and
    the checkout on ``PYTHONPATH``, heartbeats on, output unbuffered."""
    site = os.path.join(tmp, "site")
    if not os.path.isdir(site):
        os.makedirs(site)
        with open(os.path.join(site, "sitecustomize.py"), "w") as f:
            f.write(_SITE)
    env = dict(os.environ)
    env.update({"PYTHONPATH": os.pathsep.join(
        [site, _HERE] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                         else [])),
        "COMMEFFICIENT_HEARTBEAT": "1", "PYTHONUNBUFFERED": "1"})
    env.update({k: str(v) for k, v in extra.items()})
    return env


def final_npz(ckpt: str) -> dict:
    with np.load(os.path.join(ckpt, "ResNet9.npz")) as z:
        return {k: z[k] for k in z.files}


def same_npz(label: str, a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b), f"{label}: tensor sets differ"
    for k in a:
        assert np.array_equal(a[k], b[k]), f"{label}: {k} differs"


def cv_child(argv, env, timeout=600) -> dict:
    """``python -m commefficient_torch.cv_train`` to its end: its wall
    seconds and the heartbeats it printed."""
    from commefficient_torch.profiling import parse_heartbeat

    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "commefficient_torch.cv_train", *argv],
        env=env, cwd=_HERE, capture_output=True, text=True,
        timeout=timeout)
    wall = time.perf_counter() - t
    if proc.returncode != 0:
        print(proc.stdout[-3000:], proc.stderr[-6000:], sep="\n")
        raise RuntimeError(f"cv_train exited {proc.returncode}")
    beats = [hb for hb in map(parse_heartbeat, proc.stderr.splitlines())
             if hb is not None]
    return {"wall_s": wall, "beats": beats, "stdout": proc.stdout}


def run_events(run_dir: str) -> list:
    return list(read_events(os.path.join(run_dir, "telemetry.jsonl")))


def service_audit(label: str, events: list) -> dict:
    audits = [e for e in events if e["ev"] == "churn_audit"]
    assert audits, f"{label}: no churn_audit event"
    assert audits[-1]["ok"], f"{label}: churn audit failed {audits[-1]}"
    return {k: v for k, v in audits[-1].items() if k not in ("ev", "t")}


def service_launches(label: str, path: str, per_round: dict,
                     rounds: int) -> dict:
    with open(path) as f:
        counts = json.load(f)
    want = {k.name: per_round.get(k.name, 0) * rounds
            for k in kernels.KERNELS}
    assert counts == want, f"{label}: launches {counts}, expected {want}"
    return {k: v // rounds for k, v in counts.items() if v}


class _QueryLoad:
    """A query to the replica every ``SERVICE_QUERY_S`` seconds, and a
    watch on the replica's pin leases: every run state a lease names must
    exist whenever the lease is read (``prune_run_states`` never deletes
    a pinned file)."""

    def __init__(self, serve_dir: str, ckpt: str):
        import threading

        self.serve_dir, self.ckpt = serve_dir, ckpt
        self.rids, self.pin_reads, self.pin_missing = [], 0, []
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=f, daemon=True)
                         for f in (self._query, self._pins)]
        for t in self._threads:
            t.start()

    def _query(self):
        from commefficient_torch.federated.serving import submit_request

        i = 0
        while not self._stop.wait(SERVICE_QUERY_S):
            self.rids.append(submit_request(self.serve_dir, op="query",
                                            probe_seed=i))
            i += 1

    def _pins(self):
        while not self._stop.wait(0.05):
            for n in os.listdir(self.ckpt) if os.path.isdir(self.ckpt) \
                    else []:
                if not n.endswith(".pin"):
                    continue
                try:
                    with open(os.path.join(self.ckpt, n)) as f:
                        paths = json.load(f)["paths"]
                except (OSError, ValueError):
                    continue
                self.pin_reads += 1
                self.pin_missing += [
                    p for p in paths
                    if not os.path.exists(os.path.join(self.ckpt, p))]

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(10)


def service_headline(card: str, tmp: str) -> dict:
    """Leg A: the headline under churn (i) alone and (ii) under the
    port's supervisor with a SIGKILL at a seeded heartbeat round, while
    the port's replica follows the checkpoint directory under a query
    every 0.2 s."""
    import random
    import signal

    from commefficient_torch.federated.serving import read_response
    from commefficient_torch.profiling import parse_heartbeat

    data = os.path.join(tmp, "a_data")
    base = SERVICE_A + ["--dataset_dir", data]
    counts = os.path.join(tmp, "a_launches.json")
    ck1, run1 = os.path.join(tmp, "a_ck1"), os.path.join(tmp, "a_run1")
    solo = cv_child(base + ["--checkpoint_path", ck1], service_env(
        tmp, COMMEFFICIENT_SYNTHETIC_PER_CLASS=SERVICE_A_PER_CLASS,
        COMMEFFICIENT_RUN_DIR=run1, SMOKE_LAUNCH_COUNTS=counts))
    rounds = len(solo["beats"])
    assert rounds >= 20, f"service: {rounds} rounds"
    assert all("population" in hb for hb in solo["beats"]), \
        "service: a heartbeat without population="
    per_round = service_launches("service headline", counts,
                                 HEADLINE_PER_ROUND, rounds)
    audit = service_audit("service solo", run_events(run1))

    ck2, run2 = os.path.join(tmp, "a_ck2"), os.path.join(tmp, "a_run2")
    serve = os.path.join(tmp, "a_serve")
    os.makedirs(ck2)
    stop = os.path.join(tmp, "a_stop")
    env = service_env(tmp, COMMEFFICIENT_SYNTHETIC_PER_CLASS=
                      SERVICE_A_PER_CLASS, COMMEFFICIENT_RUN_DIR=run2)
    kill_round = random.Random(SERVICE_KILL_SEED).randint(
        8, max(9, rounds - 8))
    with open(os.path.join(tmp, "a_replica.log"), "w") as rlog:
        replica = subprocess.Popen(
            [sys.executable, "-m", "commefficient_torch.scripts.serve",
             "--checkpoint_path", ck2, "--serve_dir", serve,
             "--owner", "smoke", "--poll_interval", "0.05",
             "--stop_file", stop], env=env, cwd=_HERE, stdout=rlog,
            stderr=subprocess.STDOUT)
        load = _QueryLoad(serve, ck2)
        events = os.path.join(tmp, "a_supervise.jsonl")
        t = time.perf_counter()
        sup = subprocess.Popen(
            [sys.executable, "-m", "commefficient_torch.scripts.supervise",
             "--heartbeat-timeout", "120", "--startup-grace", "300",
             "--max-restarts", "2", "--backoff", "1", "--events", events,
             "--", sys.executable, "-m", "commefficient_torch.cv_train",
             *base, "--checkpoint_path", ck2], env=env, cwd=_HERE,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        pid = attempt = None
        killed_at = None
        tail = []
        try:
            for line in sup.stdout:
                tail = (tail + [line])[-40:]
                m = re.search(r"\[supervise\] launch attempt=(\d+) "
                              r"pid\(s\)=\[(\d+)", line)
                if m:
                    attempt, pid = int(m.group(1)), int(m.group(2))
                    continue
                hb = parse_heartbeat(line)
                if (hb is not None and killed_at is None and attempt == 1
                        and hb["round"] + 1 >= kill_round):
                    os.kill(pid, signal.SIGKILL)
                    killed_at = hb["round"]
            rc = sup.wait(timeout=600)
        finally:
            if sup.poll() is None:
                sup.kill()
                sup.wait()
        served_wall = time.perf_counter() - t
        load.stop()
        open(stop, "w").close()
        try:
            replica.wait(timeout=60)
        finally:
            if replica.poll() is None:
                replica.kill()
                replica.wait()
    if rc != 0:
        print("".join(tail))
    assert rc == 0, f"service: the supervisor exited {rc}"
    assert killed_at is not None, "service: the kill round never came"
    sup_evs = [json.loads(ln) for ln in open(events)]
    launches = [e for e in sup_evs if e["ev"] == "supervisor_launch"]
    assert len(launches) == 2 and launches[1]["resume"], \
        f"service: supervisor launches {launches}"
    same_npz("service supervised vs solo", final_npz(ck1), final_npz(ck2))
    audit2 = service_audit("service supervised", run_events(run2))
    assert audit2 == audit, "service: the audits differ"
    # the replica
    answers = []
    for rid in load.rids:
        try:
            answers.append(read_response(serve, rid, timeout=0.5,
                                         poll=0.05))
        except TimeoutError:
            pass
    sv = [json.loads(ln) for ln in open(os.path.join(serve,
                                                     "serving.jsonl"))]
    swaps = [e for e in sv if e["ev"] == "serving_swap"]
    versions = [e["model_version"] for e in sv
                if e["ev"] in ("serving_swap", "serving_answer")]
    assert swaps, "service: the replica never swapped"
    assert versions == sorted(versions), "service: versions not monotone"
    assert load.pin_reads and not load.pin_missing, (
        f"service: pinned files pruned {load.pin_missing} "
        f"({load.pin_reads} lease reads)")
    assert sv[-1]["ev"] == "serving_stop"
    ok = [a for a in answers if "error" not in a]
    assert ok and all(np.isfinite(a["value"]) for a in ok), \
        "service: no finite query answer"
    lat = [a["latency_ms"] for a in ok]
    out = {"rounds": rounds, "launches_per_round": per_round,
           "solo_wall_s": round(solo["wall_s"], 2),
           "served_wall_s": round(served_wall, 2),
           "served_over_solo": served_wall / solo["wall_s"],
           "killed_at_round": killed_at, "audit": audit,
           "population_last": solo["beats"][-1]["population"],
           "swaps": len(swaps),
           "swap_load_ms": [e["load_ms"] for e in swaps],
           "queries": len(load.rids), "answered": len(answers),
           "query_latency_ms_median": statistics.median(lat),
           "pin_reads": load.pin_reads, "card": card}
    print(json.dumps({"phase": "service", "leg": "headline", **out}))
    return out


def service_disk(card: str, tmp: str) -> dict:
    """Leg B: the row directory on disk: phase 14's sketch-local round at
    128 clients under churn with compaction, run in this process through
    ``cv_train.main``; the directory checked against the masks after each
    save, a compaction timed, and a resume from a save after a compaction
    bit-equal to the continuous run."""
    from commefficient_torch import cv_train
    from commefficient_torch.federated import checkpoint as tck
    from commefficient_torch.federated.host_state import MemmapRowStore

    data = os.path.join(tmp, "b_data")
    models, compactions, checks = [], [], []

    class Capture(FedModel):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            models.append(self)

    compact = MemmapRowStore.compact

    def timed_compact(store):
        t = time.perf_counter()
        stats = compact(store)
        compactions.append({
            "ms": (time.perf_counter() - t) * 1e3, **stats,
            "bytes_moved": stats["moved"] * sum(store._row_nbytes.values())})
        return stats

    snapshot = tck._save_row_snapshot

    def checked_snapshot(path, store, arrays, meta, write):
        snapshot(path, store, arrays, meta, write)
        models[-1]._population.check_directory()
        checks.append(os.path.basename(path))

    def run(ckpt, extra=()):
        kernels.reset_launch_counts()
        with env_vars(COMMEFFICIENT_SYNTHETIC_PER_CLASS=SERVICE_B_PER_CLASS,
                      COMMEFFICIENT_RUN_DIR=os.path.join(ckpt, "run"),
                      **OFF_TIERS["disk"]), deterministic_cudnn(), \
                mock.patch.object(cv_train, "FedModel", Capture), \
                mock.patch.object(MemmapRowStore, "compact", timed_compact), \
                mock.patch.object(tck, "_save_row_snapshot",
                                  checked_snapshot):
            cv_train.main(SERVICE_B + [
                "--dataset_dir", data, "--checkpoint_path", ckpt,
                "--state_dir", os.path.join(ckpt, "state"), *extra])
        fm = models[-1]
        return fm.rounds_dispatched, kernels.launch_counts()

    full = os.path.join(tmp, "b_full")
    t = time.perf_counter()
    rounds, counts = run(full)
    full_wall = time.perf_counter() - t
    cont_compactions = list(compactions)
    want = {k.name: OFF_PER_ROUND.get(k.name, 0) * rounds
            for k in kernels.KERNELS}
    assert counts == want, f"service disk: launches {counts}, {want}"
    evs = run_events(os.path.join(full, "run"))
    kinds = [e["ev"] for e in evs]
    assert "rows_retired" in kinds and "rows_compacted" in kinds, \
        "service disk: no retirement or no compaction"
    audit = service_audit("service disk", evs)
    assert cont_compactions and len(checks) >= rounds // 5, (
        cont_compactions, checks)
    # the last save after a compaction that leaves rounds to run
    saves = sorted((f for f in os.listdir(full) if f.endswith(".npz")
                    and f.startswith("run_state")),
                   key=lambda f: tck._run_state_progress(f))
    pick = None
    for f in reversed(saves[:-1]):
        with np.load(os.path.join(full, f)) as z:
            meta = json.loads(bytes(z["meta_json"]).decode())
        if meta["client_store"]["directory"]["compactions"] > 0:
            pick = f
            break
    assert pick is not None, f"service disk: no save after a compaction"
    res = os.path.join(tmp, "b_res")
    os.makedirs(res)
    shutil.copy(os.path.join(full, pick), os.path.join(res, pick))
    shutil.copytree(os.path.join(full, pick[:-4] + ".rows"),
                    os.path.join(res, pick[:-4] + ".rows"))
    run(res, ["--resume", "auto"])
    same_npz("service disk resume", final_npz(full), final_npz(res))
    out = {"rounds": rounds,
           "launches_per_round": {k: v // rounds for k, v in counts.items()
                                  if v},
           "saves_checked": len(checks), "resumed_from": pick,
           "compactions": cont_compactions, "audit": audit,
           "continuous_wall_s": round(full_wall, 2), "card": card}
    print(json.dumps({"phase": "service", "leg": "disk", **out}))
    return out


def service_fleet(card: str, tmp: str) -> dict:
    """Leg C: two tenants of 10 headline rounds on the card under the
    port's orchestrator (``--max-concurrent 2``, warm admission), each
    against a solo run of the same command."""
    from commefficient_torch.scripts.orchestrate import orchestrate

    data = os.path.join(tmp, "c_data")
    argv = SERVICE_C + ["--dataset_dir", data]
    env = service_env(tmp, COMMEFFICIENT_SYNTHETIC_PER_CLASS=
                      SERVICE_C_PER_CLASS)
    solo_ck = os.path.join(tmp, "c_solo")
    solo = cv_child(argv + ["--checkpoint_path", solo_ck], dict(
        env, COMMEFFICIENT_RUN_DIR=os.path.join(tmp, "c_solo_run")))
    fleet = os.path.join(tmp, "c_fleet")
    t = time.perf_counter()
    with env_vars(**{k: env[k] for k in (
            "PYTHONPATH", "COMMEFFICIENT_HEARTBEAT", "PYTHONUNBUFFERED",
            "COMMEFFICIENT_SYNTHETIC_PER_CLASS")}), \
            open(os.path.join(tmp, "c_fleet.log"), "w") as log:
        rc = orchestrate([["-m", "commefficient_torch.cv_train", *argv]] * 2,
                         fleet_dir=fleet, max_concurrent=2,
                         heartbeat_timeout=120, startup_grace=300,
                         max_restarts=1, out=log)
    wall = time.perf_counter() - t
    assert rc == 0, f"service fleet: rc {rc}"
    evs = [json.loads(ln)
           for ln in open(os.path.join(fleet, "fleet_events.jsonl"))]
    idx = {id(e): i for i, e in enumerate(evs)}
    admits = [e for e in evs if e["ev"] == "tenant_admit"]
    assert [e["tenant"] for e in admits] == [0, 1]
    first0 = next(e for e in evs if e["ev"] == "tenant_progress"
                  and e["tenant"] == 0)
    assert idx[id(admits[1])] > idx[id(first0)], \
        "service fleet: tenant 1 admitted before tenant 0's heartbeat"
    done = evs[-1]
    assert done["ev"] == "fleet_done" and done["admitted"] == \
        done["finished"] + done["gave_up"] == 2, done
    want = final_npz(solo_ck)
    for i in range(2):
        same_npz(f"service fleet tenant {i}", want,
                 final_npz(os.path.join(fleet, f"t{i}", "ckpt")))
    out = {"solo_wall_s": round(solo["wall_s"], 2),
           "fleet_wall_s": round(wall, 2),
           "fleet_rounds": done["total_rounds"],
           "rounds_per_sec": done["rounds_per_sec"], "card": card}
    print(json.dumps({"phase": "service", "leg": "fleet", **out}))
    return out


def phase_service(card: str) -> dict:
    """Phase 15: the open-world service."""
    tmp = tempfile.mkdtemp(prefix="service_")
    out, wall = {}, {}
    try:
        for name, leg in (("headline", service_headline),
                          ("disk", service_disk),
                          ("fleet", service_fleet)):
            t = time.perf_counter()
            out[name] = leg(card, tmp)
            wall[name] = round(time.perf_counter() - t, 2)
            print(f"service leg wall seconds: {json.dumps(wall)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["wall_s"] = wall
    return out


# --------------------------------------------------------------------------
# phase 16: the 2-D (clients x shard) plane
# --------------------------------------------------------------------------

GRID_2D = ["--server_shard", "--num_devices", "2", "--shard_devices", "2"]
GRID_1D = ["--server_shard", "--num_devices", "4", "--shard_devices", "1"]
# the per-axis leg: the table's clients level int8, the downlink's dcn
# level (clients, forced to dcn) int8
GRID_PLAN = "table=shard:fp32/clients:int8,downlink=dcn:int8"
GRID_DENSE = ["--mode", "uncompressed", "--error_type", "none",
              "--collective_plan", "uplink=shard:fp32/clients:int8"]
GRID_PLAN_ROUNDS = 3
GRID_PAIRS = 2
GRID_PAIR_ROUNDS = 4
# the error-feedback identity's bound, relative to the largest magnitude
GRID_EF_RTOL = 1e-6


def grid_ef_identity(fm, opt, grid, batch, label: str) -> dict:
    """The per-level error-feedback identity of the per-axis leg on the
    card, at full width, on this rank of the 2-D grid: the round's own
    table through the table leg's ``hierarchical_psum`` (its clients
    level int8) with the carries it holds and the round's generators,
    where the sum plus the clients axis' new carries equals the exact
    shard sums plus their old carries; and an update-sized tile through
    the downlink's ``hierarchical_all_gather``, where this rank's
    gathered chunks plus its new carry equal the tile plus its old carry.
    Bound: ``GRID_EF_RTOL`` times the largest magnitude."""
    from commefficient_torch.ops import collectives as coll

    low = fm._plan_lowering
    cs = fm.sketch
    fm.begin_round(batch)
    table = fm._round_ctx.gradient
    st = opt.server_state
    sr = fm.sr_generators(fm.rounds_dispatched - 1)
    out = {}
    got, new = coll.hierarchical_psum(table, low["table"], grid, sr["up"],
                                      residuals=st.qres, block=cs.c_pad)
    assert new[0] is None and st.qres[0] is None, label
    clients = grid.axis("clients")
    exact = coll.all_reduce_sum(table.clone(), grid.axis("shard"))
    lhs = got + coll.all_reduce_sum(new[1].clone(), clients)
    rhs = coll.all_reduce_sum(exact + st.qres[1], clients)
    scale = float(rhs.abs().max())
    err = float((lhs - rhs).abs().max())
    assert err <= GRID_EF_RTOL * scale, f"{label}: table identity {err}"
    out["table_identity_max_err"] = err
    out["table_identity_scale"] = scale
    Tn = -(-cs.T // grid.size)
    t0 = grid.rank * Tn
    upd = tsk.unsketch_chunks(cs, st.error, fm.server_config.k)[t0:t0 + Tn]
    upd = torch.nn.functional.pad(upd, (0, 0, 0, 0, 0, Tn - upd.shape[0]))
    full, new = coll.hierarchical_all_gather(
        upd, low["downlink"], grid, sr["down"], residuals=st.dres,
        block=cs.sublanes * 128)
    assert new[0] is None and st.dres[0] is None, label
    mine = full[grid.rank * Tn:(grid.rank + 1) * Tn]
    contrib = upd + st.dres[1]
    scale = float(contrib.abs().max())
    err = float((mine + new[1] - contrib).abs().max())
    assert err <= GRID_EF_RTOL * max(scale, 1e-30), \
        f"{label}: downlink identity {err}"
    out["downlink_identity_max_err"] = err
    out["downlink_identity_scale"] = scale
    opt.step()
    return out


def release_card() -> dict:
    """Free what this process no longer uses on the card before spawned
    ranks need it: collect unreachable objects (a model kept alive by a
    reference cycle holds its device memory until the collector runs),
    then return the allocator's cached blocks. Returns what stays held."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"allocated_GiB": torch.cuda.memory_allocated() / 2**30,
            "reserved_GiB": torch.cuda.memory_reserved() / 2**30}


def _grid_rank(index: int, tmp: str) -> None:
    """One rank of phase 16: gloo on ``cuda:0``, the process group
    numbered by the tuple index of device ``index`` (as ``cv_train``
    starts it), cuDNN deterministic; every leg's weights, launches and
    checks written to ``tmp``."""
    import torch.distributed as dist

    from commefficient_torch.federated.checkpoint import save_run_state
    from commefficient_torch.parallel import make_client_group, tuple_index

    p = tuple_index(index, 2, 2)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=p, world_size=4)
    out = {"rank": p}

    def save(name, t):
        np.save(os.path.join(tmp, f"{name}{p}.npy"), t.cpu().numpy())

    try:
        kernels.library()
        # the headline's device (cuda), its first card
        dev = torch.device(HEADLINE[HEADLINE.index("--device") + 1], 0)
        g2 = make_client_group(8, 2, dev, shard_devices=2)
        g1 = make_client_group(8, 4, dev)
        assert g2.rank == g1.rank == p and g2.size == g1.size == 4
        assert g2.server_axes == ("shard", "clients")
        out["placement"] = g2.axis_placement()
        with deterministic_cudnn():
            # (a) the 2-D and the 1-D fp32 round, and the 2-D run state
            _, fm2, opt2, sched2, r2 = _build_group_round(GRID_2D, g2)
            assert fm2.collective_plan.spec() == \
                "uplink=float32,table=float32,downlink=float32"
            kernels.reset_launch_counts()
            loss = r2(synthetic_batch(0))[0]
            out["launches_2d"] = kernels.launch_counts()
            assert np.all(np.isfinite(loss))
            save("w2d_r1_", _weights(fm2))
            state = save_run_state(os.path.join(tmp, "rs2d"), fm2, opt2,
                                   sched2, next_epoch=1)
            r2(synthetic_batch(1))
            save("w2d_r2_", _weights(fm2))
            save("vel2d_r2_", opt2.server_state.velocity)
            save("err2d_r2_", opt2.server_state.error)
            r2(synthetic_batch(2))
            w2d_r3 = _weights(fm2)
            _, fm1, opt1, sched1, r1 = _build_group_round(GRID_1D, g1)
            kernels.reset_launch_counts()
            r1(synthetic_batch(0))
            out["launches_1d"] = kernels.launch_counts()
            save("w1d_r1_", _weights(fm1))
            _, fmf, optf, schedf, rf = _build_group_round(
                GRID_2D + ["--fused_epilogue"], g2)
            kernels.reset_launch_counts()
            loss = rf(synthetic_batch(0))[0]
            out["launches_2d_fused"] = kernels.launch_counts()
            assert np.all(np.isfinite(loss))
            del fmf, optf, schedf, rf
            # (d) the 2-D run state on the 1-D plane, one more round
            _, fmr, optr, schedr, rr = _build_group_round(GRID_1D, g1)
            load_run_state(state, fmr, optr, schedr)
            rr(synthetic_batch(1))
            save("wrs_r2_", _weights(fmr))
            save("velrs_r2_", optr.server_state.velocity)
            save("errrs_r2_", optr.server_state.error)
            del fmr, optr, schedr, rr
            # (b) the per-axis plan, 3 rounds and the identity
            _, fmq, optq, schedq, rq = _build_group_round(
                GRID_2D + ["--collective_plan", GRID_PLAN], g2)
            out["lowering"] = {k: (list(map(list, v)) if isinstance(v, tuple)
                                   else v)
                               for k, v in fmq._plan_lowering.items()}
            out["plan_losses"] = []
            for i in range(GRID_PLAN_ROUNDS):
                kernels.reset_launch_counts()
                loss = rq(synthetic_batch(i))[0]
                out["plan_losses"].append(float(np.mean(loss)))
            out["launches_plan"] = kernels.launch_counts()
            wq = _weights(fmq)
            save("wq_r3_", wq)
            out["plan_rel_diff_vs_fp32"] = float(
                (wq - w2d_r3).abs().max() / w2d_r3.abs().max())
            out["ef"] = grid_ef_identity(fmq, optq, g2, synthetic_batch(3),
                                         "per-axis")
            st = optq.server_state
            out["carries"] = {name: [None if c is None else float(
                c.abs().max()) for c in getattr(st, name)]
                for name in ("qres", "dres")}
            # (c) uncompressed under a per-axis uplink, 2 rounds
            _, fmu, optu, schedu, ru = _build_group_round(
                GRID_2D + GRID_DENSE, g2)
            out["dense_losses"] = [float(np.mean(ru(synthetic_batch(i))[0]))
                                   for i in range(2)]
            save("wu_r2_", fmu.ps_weights)
            out["dense_carries"] = [None if c is None else float(
                c.abs().max()) for c in optu.server_state.qres]
            del fmu, optu, schedu, ru
            torch.cuda.empty_cache()
            # rounds/sec in alternating pairs (the 2-D, the 1-D and the
            # per-axis round), on rank 0's clock
            batch = synthetic_batch(4)
            times = {"2d fp32": [], "1d fp32": [], "2d per-axis": []}
            for _ in range(GRID_PAIRS):
                for name, one in (("2d fp32", r2), ("1d fp32", r1),
                                  ("2d per-axis", rq)):
                    dist.barrier()
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    for _ in range(GRID_PAIR_ROUNDS):
                        one(batch)
                    torch.cuda.synchronize()
                    times[name].append(GRID_PAIR_ROUNDS
                                       / (time.perf_counter() - t))
            out["rounds_per_sec"] = times
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{p}.json"), "w") as f:
        json.dump(out, f)


def grid_auto_run(card: str) -> dict:
    """Step (e): ``torchrun --nproc_per_node 1 -m
    commefficient_torch.cv_train --server_shard --collective_plan auto``
    on synthetic CIFAR10 with telemetry on: exit 0, finite losses, and
    the run log's ``run_start`` holding the probe's report, its round
    trips timed on the card (every candidate's ``probe_ms`` > 0), and the
    plan the report's own rule picks."""
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, "run")
        env = dict(os.environ, COMMEFFICIENT_SYNTHETIC_PER_CLASS="16",
                   COMMEFFICIENT_RUN_DIR=run_dir,
                   PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        env.pop("COMMEFFICIENT_FORCE_DCN_AXIS", None)
        argv = [a for a in HEADLINE if a != "--no_telemetry"]
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "1", "-m", "commefficient_torch.cv_train",
               *argv, "--server_shard", "--collective_plan", "auto",
               "--dataset_dir", os.path.join(tmp, "cifar10"), "--iid",
               "--num_clients", "16", "--num_epochs", "1", "--seed", "0"]
        t = time.perf_counter()
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=300)
        wall = time.perf_counter() - t
        if proc.returncode != 0:
            print(proc.stdout[-4000:])
            print(proc.stderr[-4000:], file=sys.stderr)
        assert proc.returncode == 0, \
            f"torchrun cv_train auto exit {proc.returncode}"
        events = list(read_events(os.path.join(run_dir, "telemetry.jsonl")))
    row = table_row(proc.stdout, "train_loss")
    for key in ("train_loss", "test_loss"):
        assert np.isfinite(float(row[key])), row
    start = next(e for e in events if e["ev"] == "run_start")
    report = start["collective_plan_probe"]
    budget = 0.05
    chosen = {}
    for leg, rows in report.items():
        best = ("float32", rows["float32"]["bytes_per_round"], 0.0)
        for dt, r in rows.items():
            assert "error" not in r, (leg, dt, r)
            if dt == "float32":
                continue
            assert r["probe_ms"] > 0, (leg, dt, r)
            if r["rel_err"] <= budget and (
                    r["bytes_per_round"] < best[1]
                    or (r["bytes_per_round"] == best[1]
                        and r["rel_err"] < best[2])):
                best = (dt, r["bytes_per_round"], r["rel_err"])
        chosen[leg] = best[0]
    assert set(report) == {"table", "downlink"}, report
    want = ",".join(f"{leg}={chosen.get(leg, 'float32')}"
                    for leg in ("uplink", "table", "downlink"))
    assert start["collective_plan"] == want, (start["collective_plan"], want)
    out = {"phase": "2-D plane", "step": "torchrun cv_train auto",
           "plan": start["collective_plan"], "probe": report, "row": row,
           "wall_s": wall, "card": card}
    print(json.dumps(out))
    return out


def phase_grid(card: str) -> dict:
    """Phase 16: the 2-D (clients x shard) plane. Four gloo ranks on
    ``cuda:0`` (two NCCL ranks cannot share a card; gloo stages every
    collective through the host, so nothing here measures NVLink) with
    ``COMMEFFICIENT_FORCE_DCN_AXIS=clients`` and cuDNN deterministic:
    (a) the headline round under ``--num_devices 2 --shard_devices 2``
    (fp32) bit-equal to the same ranks as one clients axis
    (``--num_devices 4``) on every rank, 2 / 1 / 8 launches a round per
    rank (rank 3: ``t0 = 12``, two valid chunks and a padded tail) and
    SHARDED_FUSED_PER_ROUND under ``--fused_epilogue``; (b) GRID_PLAN for
    3 rounds: finite, the ranks equal, within 5% of the fp32 run's
    weights, each quantized level's error-feedback identity on the card;
    (c) ``uncompressed`` under a per-axis uplink for 2 rounds: finite,
    the ranks equal; (d) the 2-D run state restored on the 1-D plane:
    the next round's weights and server state bit-equal; (e)
    ``grid_auto_run``. Rounds/sec of the 2-D, the 1-D and the per-axis
    round in GRID_PAIRS alternating triples (data, no claim)."""
    import multiprocessing as mp

    held = release_card()
    print("phase 16: this process holds " + json.dumps(held)
          + " on the card before its ranks start")
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, \
            env_vars(COMMEFFICIENT_FORCE_DCN_AXIS="clients"):
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_grid_rank, args=(i, tmp))
                 for i in range(4)]
        for pr in procs:
            pr.start()
        for pr in procs:
            pr.join(max(1.0, 400 - (time.perf_counter() - t)))
        alive = [pr for pr in procs if pr.is_alive()]
        for pr in alive:
            pr.kill()
            pr.join()
        assert not alive, "phase 16 ranks timed out"
        assert all(pr.exitcode == 0 for pr in procs), \
            [pr.exitcode for pr in procs]
        ranks = []
        for p in range(4):
            with open(os.path.join(tmp, f"rank{p}.json")) as f:
                ranks.append(json.load(f))
        w = {name: [np.load(os.path.join(tmp, f"{name}{p}.npy"))
                    .view(np.uint32) for p in range(4)]
             for name in ("w2d_r1_", "w1d_r1_", "w2d_r2_", "vel2d_r2_",
                          "err2d_r2_", "wrs_r2_", "velrs_r2_", "errrs_r2_",
                          "wq_r3_", "wu_r2_")}
    ranks_s = time.perf_counter() - t

    def nonzero(counts):
        return {k: v for k, v in counts.items() if v}

    for p, r in enumerate(ranks):
        assert r["placement"] == {"clients": "dcn", "shard": "ici"}, r
        for key, want in (("launches_2d", SHARDED_PER_ROUND),
                          ("launches_1d", SHARDED_PER_ROUND),
                          ("launches_2d_fused", SHARDED_FUSED_PER_ROUND),
                          ("launches_plan", SHARDED_PER_ROUND)):
            assert nonzero(r[key]) == want, (p, key, r[key], want)
        assert r["lowering"] == {
            "uplink": "float32",
            "table": [["shard", "float32"], ["clients", "int8"]],
            "downlink": [["shard", "float32"], ["clients", "int8"]]}, r
        assert all(np.isfinite(r["plan_losses"])), r["plan_losses"]
        assert r["plan_rel_diff_vs_fp32"] < 0.05, r["plan_rel_diff_vs_fp32"]
        assert all(np.isfinite(r["dense_losses"])), r["dense_losses"]
        for name in ("qres", "dres"):
            assert r["carries"][name][0] is None, (p, name)
        assert r["dense_carries"][0] is None and r["dense_carries"][1] > 0
    assert max(r["carries"]["qres"][1] for r in ranks) > 0
    assert max(r["carries"]["dres"][1] for r in ranks) > 0
    for p in range(4):
        assert np.array_equal(w["w2d_r1_"][p], w["w1d_r1_"][p]), \
            f"rank {p}: 2-D round != 1-D round"
        for name in ("w2d_r1_", "w2d_r2_", "wq_r3_", "wu_r2_"):
            assert np.array_equal(w[name][p], w[name][0]), (name, p)
        for a, b in (("wrs_r2_", "w2d_r2_"), ("velrs_r2_", "vel2d_r2_"),
                     ("errrs_r2_", "err2d_r2_")):
            assert np.array_equal(w[a][p], w[b][p]), \
                f"rank {p}: restored 1-D {a} != 2-D {b}"
    rps = ranks[0]["rounds_per_sec"]
    out = {"phase": "2-D plane", "card": card,
           "launches_per_round_rank3": nonzero(ranks[3]["launches_2d"]),
           "launches_per_round_rank3_fused": nonzero(
               ranks[3]["launches_2d_fused"]),
           "plan_rel_diff_vs_fp32": max(r["plan_rel_diff_vs_fp32"]
                                        for r in ranks),
           "ef": [r["ef"] for r in ranks],
           "rounds_per_sec": rps,
           "rounds_per_sec_median": {k: statistics.median(v)
                                     for k, v in rps.items()},
           "ranks_wall_s": ranks_s,
           "note": "gloo stages every collective through the host: these "
                   "rates measure nothing of NVLink"}
    print(json.dumps(out))
    out["auto"] = grid_auto_run(card)
    return out


# phase 17: GPT-2's sequence parallelism (item 7.1) at GPT-2-small's full
# width (config 5): two gloo ranks as (clients 1) x (seq 2) under ring and
# Ulysses attention, four as (clients 2) x (seq 2), and gpt2_train
SEQ_ROUNDS = 2
SEQ_GRID_ROUNDS = 2
SEQ_TIMED_ROUNDS = 2
# the seq-parallel summed gradient against the one-rank round's: fp32
# sums in another order (the ring's blockwise online softmax and the
# Ulysses head split, matrix products at half the sequence, the seq
# all-reduce of the two halves' partial gradients); elementwise
# |seq - dense| <= SEQ_GRAD_ATOL * max|dense| + SEQ_GRAD_RTOL * |dense|
SEQ_GRAD_ATOL = 2e-5
SEQ_GRAD_RTOL = 1e-3
# per-client losses: the CPU tests' GPT-2 tolerance
SEQ_LOSS_RTOL = 1e-4


def seq_batch(seed: int):
    """``gpt2_batch`` with the collate's ``lm_labels_shifted`` (the target
    of position t over the whole sequence, -1 at the last slot)."""
    b = gpt2_batch(seed)
    shifted = np.full_like(b["lm_labels"], -1)
    shifted[..., :-1] = b["lm_labels"][..., 1:]
    b["lm_labels_shifted"] = shifted
    return b


def build_seq_gpt2(extra, group=None):
    """Phase 9's GPT-2 round at dropout 0 (so the parallel and the
    one-rank rounds compute the same function), on ``group`` with its
    seq axis under ``--seq_parallel``, its model and expert axes (the
    MoE model under ``--n_experts``) and its stage axis (the pipelined
    loss, ``--pp_microbatches``); returns ``(fm, one_round)``."""
    args = parse_args(default_lr=4e-2, argv=GPT2_BASE + list(extra) + [
        "--dataset_name", "PERSONA", "--num_clients", "8"])
    seq = group.seq if group is not None else None
    model = GPT2DoubleHeads(
        **GPT2_MODEL, dropout=0.0,
        **({"attn_impl": args.seq_parallel, "seq_group": seq} if seq
           else {}),
        model_group=group.model if group is not None else None,
        expert_group=group.expert if group is not None else None,
        n_experts=args.n_experts, moe_dispatch=args.moe_dispatch,
        moe_capacity_factor=args.moe_capacity_factor)
    aux = args.moe_aux_coef if args.n_experts else 0.0
    if group is not None and group.stage is not None:
        train_loss, val_loss = make_gpt2_pp_losses(
            model, group.stage, n_micro=args.pp_microbatches,
            moe_aux_coef=aux)
    else:
        train_loss, val_loss = make_gpt2_losses(model, seq_group=seq,
                                                moe_aux_coef=aux)
    fm = FedModel(model, train_loss, args, val_loss, num_clients=8,
                  group=group)
    assert fm.grad_size == (MOE_D if args.n_experts else GPT2_D), \
        fm.grad_size
    opt = FedOptimizer(fm, args)
    schedule = PiecewiseLinear([0, 100], [args.lr_scale, 0.0])
    sched = LambdaLR(opt, lambda step: schedule(step))

    def one_round(batch):
        sched.step()
        out = fm(batch)
        opt.step()
        return out

    return fm, one_round


@contextlib.contextmanager
def summed_gradient(store: list):
    """Record the fused client phase's summed gradient (the chunked
    ``(T, S, 128)`` plane handed to the one client sketch), on the card."""
    from commefficient_torch.federated import rounds

    inner = rounds.sketch_chunks

    def spy(sketch, x):
        store.append(x.detach().clone())
        return inner(sketch, x)

    with mock.patch.object(rounds, "sketch_chunks", spy):
        yield


def seq_device() -> torch.device:
    """The GPT-2 round's device (``cuda``), its first card."""
    return torch.device(GPT2_BASE[GPT2_BASE.index("--device") + 1], 0)


def w_hash(fm) -> str:
    """SHA-256 of the weights' bytes: equal hashes, bit-equal weights."""
    import hashlib

    return hashlib.sha256(_weights(fm).cpu().numpy().tobytes()).hexdigest()


def _seq_pair(i: int, tmp: str) -> dict:
    """Stage 1 on ranks 0 and 1: (clients 1) x (seq 2) under ring, then
    Ulysses: round 1's summed gradient and losses against the one-rank
    round's (``tmp/dense_*``), SEQ_ROUNDS finite rounds with 2 / 1 / 8
    launches each, and the weights' hash."""
    import torch.distributed as dist

    from commefficient_torch.parallel import make_client_group

    dist.init_process_group("gloo", init_method=f"file://{tmp}/store_a",
                            rank=i, world_size=2)
    out = {}
    try:
        dev = seq_device()
        g = make_client_group(GPT2_W, 1, dev, seq_devices=2)
        assert (g.rank, g.size, g.seq.rank, g.seq.size) == (0, 1, i, 2)
        ref = torch.from_numpy(np.load(os.path.join(tmp, "dense_g.npy")))
        ref = ref.to(dev)
        ref_loss = np.load(os.path.join(tmp, "dense_loss.npy"))
        scale = float(ref.abs().max())
        for impl in ("ring", "ulysses"):
            fm, one = build_seq_gpt2(["--seq_parallel", impl,
                                      "--seq_devices", "2",
                                      "--num_devices", "1"], g)
            assert fm.worker_config.seq_axis == "seq"
            rec = {"launches": [], "losses": []}
            for r in range(SEQ_ROUNDS):
                grads = []
                kernels.reset_launch_counts()
                with summed_gradient(grads):
                    loss = one(seq_batch(r))[0]
                torch.cuda.synchronize()
                rec["launches"].append(kernels.launch_counts())
                rec["losses"].append(loss.tolist())
                assert np.all(np.isfinite(loss)), (impl, r, loss)
                if r == 0:
                    err = (grads[0] - ref).abs()
                    bound = SEQ_GRAD_ATOL * scale + SEQ_GRAD_RTOL * ref.abs()
                    rec["grad_max_abs_err"] = float(err.max())
                    rec["grad_scale"] = scale
                    rec["grad_within"] = bool((err <= bound).all())
                    rec["loss_max_rel_err"] = float(np.max(
                        np.abs(loss - ref_loss) / np.abs(ref_loss)))
            rec["w_hash"] = w_hash(fm)
            rec["peak_memory_GB"] = torch.cuda.max_memory_allocated() / 1e9
            out[impl] = rec
            del fm, one
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return out


def _seq_cli(i: int, tmp: str) -> dict:
    """Stage 1 on ranks 2 and 3: ``gpt2_train`` under ``--seq_parallel
    ring --bf16`` on two gloo ranks on ``cuda:0`` (dropout 0.1: each seq
    rank draws its own masks), a fraction of an epoch of the synthetic
    PersonaChat, and the val pass."""
    from commefficient_torch import gpt2_train

    os.environ.update(RANK=str(i - 2), WORLD_SIZE="2", LOCAL_RANK="0",
                      LOCAL_WORLD_SIZE="2",
                      COMMEFFICIENT_SYNTHETIC_CLIENTS="8",
                      COMMEFFICIENT_RUN_DIR=os.path.join(tmp, "cli_run"))
    kernels.reset_launch_counts()
    stats = gpt2_train.train(GPT2_BASE + [
        "--dataset_dir", os.path.join(tmp, "persona"), "--num_epochs",
        "0.3", "--bf16", "--seq_parallel", "ring", "--seq_devices", "2",
        "--num_devices", "1"],
        init_method=f"file://{tmp}/store_cli", backend="gloo")
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        os.environ.pop(key)
    return {"stats": {k: float(v) for k, v in stats.items()},
            "launches": kernels.launch_counts()}


def _seq_grid(i: int, tmp: str) -> dict:
    """Stage 2 on all four ranks: the (clients 2) x (seq 2) grid under
    ring, SEQ_GRID_ROUNDS finite rounds with 2 / 1 / 8 launches each, the
    weights' hash, then SEQ_TIMED_ROUNDS timed rounds."""
    import torch.distributed as dist

    from commefficient_torch.parallel import make_client_group, tuple_index

    rank = tuple_index(i, 2, 1, 2)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store_b",
                            rank=rank, world_size=4)
    try:
        g = make_client_group(GPT2_W, 2, seq_device(), seq_devices=2)
        assert (g.rank * 2 + g.seq.rank, g.size, g.seq.size) == (rank, 2, 2)
        fm, one = build_seq_gpt2(["--seq_parallel", "ring", "--seq_devices",
                                  "2", "--num_devices", "2"], g)
        rec = {"rank": rank, "launches": [], "losses": []}
        for r in range(SEQ_GRID_ROUNDS):
            kernels.reset_launch_counts()
            loss = one(seq_batch(r))[0]
            torch.cuda.synchronize()
            rec["launches"].append(kernels.launch_counts())
            rec["losses"].append(loss.tolist())
            assert np.all(np.isfinite(loss)), (r, loss)
        rec["w_hash"] = w_hash(fm)
        batch = seq_batch(SEQ_GRID_ROUNDS)
        dist.barrier()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(SEQ_TIMED_ROUNDS):
            one(batch)
        torch.cuda.synchronize()
        rec["rounds_per_sec"] = SEQ_TIMED_ROUNDS / (time.perf_counter() - t)
    finally:
        dist.destroy_process_group()
    return rec


def _seq_rank(i: int, tmp: str) -> None:
    """One process of phase 17: stage 1 (ranks 0-1: ``_seq_pair``; ranks
    2-3: ``_seq_cli``), then stage 2 (``_seq_grid``); its record written
    to ``tmp``."""
    kernels.library()
    with deterministic_cudnn():
        out = {"stage1": (_seq_pair if i < 2 else _seq_cli)(i, tmp)}
        out["stage2"] = _seq_grid(i, tmp)
    with open(os.path.join(tmp, f"seq{i}.json"), "w") as f:
        json.dump(out, f)


def phase_seq(card: str) -> dict:
    """Phase 17: GPT-2's sequence parallelism at GPT-2-small's full width
    (config 5: d = 124,444,417, T = 256, 4 clients x 2 examples x 2
    candidates, the 5 x 500,000 sketch, k = 50,000) on gloo ranks on
    ``cuda:0`` (two NCCL ranks cannot share a card; gloo stages every
    collective, the 497.8 MB gradient sum over seq included, through the
    host), dropout 0 and cuDNN deterministic:

    (a) the one-rank round in this process: its summed gradient and
        losses, and its rounds/sec;
    (b) two ranks as (clients 1) x (seq 2), ring and then Ulysses: round
        1's summed gradient within SEQ_GRAD_ATOL / SEQ_GRAD_RTOL of the
        one-rank round's and its losses within SEQ_LOSS_RTOL, SEQ_ROUNDS
        finite rounds, the two ranks' weights bit-equal, 2 / 1 / 8
        launches of kernels 1 / 3 / 5 a round on each rank;
    (c) meanwhile, two more ranks: ``gpt2_train`` under ``--seq_parallel
        ring --bf16``: finite val NLL, both ranks alike, the headline
        kernels launched;
    (d) four ranks as (clients 2) x (seq 2) under ring: SEQ_GRID_ROUNDS
        finite rounds, weights bit-equal on all four, 2 / 1 / 8 launches;
    (e) tokens/sec of the (clients 2) x (seq 2) round, with nothing else
        on the card, beside the one-rank round's (data, no claim)."""
    import multiprocessing as mp

    release_card()
    t = time.perf_counter()
    tokens = GPT2_W * GPT2_B * GPT2_C * GPT2_T
    with tempfile.TemporaryDirectory() as tmp, deterministic_cudnn():
        fm, one = build_seq_gpt2([])
        grads = []
        with summed_gradient(grads):
            loss = one(seq_batch(0))[0]
        dense_g = grads[0].cpu().numpy()
        np.save(os.path.join(tmp, "dense_g.npy"), dense_g)
        np.save(os.path.join(tmp, "dense_loss.npy"), loss)
        one(seq_batch(1))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(SEQ_TIMED_ROUNDS):
            one(seq_batch(SEQ_ROUNDS))
        torch.cuda.synchronize()
        dense_rps = SEQ_TIMED_ROUNDS / (time.perf_counter() - t1)
        del fm, one, grads
        held = release_card()
        print("phase 17: this process holds " + json.dumps(held)
              + " on the card before its ranks start")
        dense_s = time.perf_counter() - t
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_seq_rank, args=(i, tmp))
                 for i in range(4)]
        for pr in procs:
            pr.start()
        for pr in procs:
            pr.join(max(1.0, 300 - (time.perf_counter() - t)))
        alive = [pr for pr in procs if pr.is_alive()]
        for pr in alive:
            pr.kill()
            pr.join()
        assert not alive, "phase 17 ranks timed out"
        assert all(pr.exitcode == 0 for pr in procs), \
            [pr.exitcode for pr in procs]
        ranks = []
        for i in range(4):
            with open(os.path.join(tmp, f"seq{i}.json")) as f:
                ranks.append(json.load(f))

    def nonzero(counts):
        return {k: v for k, v in counts.items() if v}

    pair = [r["stage1"] for r in ranks[:2]]
    for impl in ("ring", "ulysses"):
        for i, p in enumerate(pair):
            rec = p[impl]
            assert rec["grad_within"], (impl, i, rec["grad_max_abs_err"],
                                        rec["grad_scale"])
            assert rec["loss_max_rel_err"] <= SEQ_LOSS_RTOL, \
                (impl, i, rec["loss_max_rel_err"])
            for counts in rec["launches"]:
                assert nonzero(counts) == HEADLINE_PER_ROUND, \
                    (impl, i, counts)
        assert pair[0][impl]["w_hash"] == pair[1][impl]["w_hash"], \
            f"{impl}: the seq ranks' weights differ"
        assert pair[0][impl]["losses"] == pair[1][impl]["losses"], impl
    cli = [r["stage1"] for r in ranks[2:]]
    keys = ("val_nll", "val_acc", "val_ppl")
    for c in cli:
        assert np.isfinite(c["stats"]["val_nll"]), c
        assert all((c["launches"][k] > 0) == (k in HEADLINE_KERNELS)
                   for k in c["launches"]), c["launches"]
    assert [cli[0]["stats"][k] for k in keys] == \
        [cli[1]["stats"][k] for k in keys], cli
    grid = [r["stage2"] for r in ranks]
    assert sorted(g["rank"] for g in grid) == [0, 1, 2, 3]
    assert len({g["w_hash"] for g in grid}) == 1, \
        "the 2 x 2 grid's ranks' weights differ"
    for g in grid:
        for counts in g["launches"]:
            assert nonzero(counts) == HEADLINE_PER_ROUND, (g["rank"], counts)
    grid_rps = grid[0]["rounds_per_sec"]
    out = {"phase": "sequence parallelism", "card": card,
           "grad_max_abs_err": {impl: max(p[impl]["grad_max_abs_err"]
                                          for p in pair)
                                for impl in ("ring", "ulysses")},
           "grad_scale": pair[0]["ring"]["grad_scale"],
           "loss_max_rel_err": {impl: max(p[impl]["loss_max_rel_err"]
                                          for p in pair)
                                for impl in ("ring", "ulysses")},
           "launches_per_round_per_rank": nonzero(grid[0]["launches"][0]),
           "peak_memory_GB_rank0": {impl: pair[0][impl]["peak_memory_GB"]
                                    for impl in ("ring", "ulysses")},
           "cli": cli[0]["stats"],
           "tokens_per_sec": {"one rank": dense_rps * tokens,
                              "clients 2 x seq 2 ring": grid_rps * tokens},
           "one_rank_s": dense_s, "wall_s": time.perf_counter() - t,
           "note": "gloo stages the 497.8 MB gradient sum over seq (and "
                   "every other collective) through the host: these rates "
                   "measure nothing of NVLink"}
    print(json.dumps(out))
    # the one-rank round's reference, which phase 18 holds its tensor-
    # parallel round to (the same round: phase 9's model at dropout 0)
    out["dense_ref"] = {"g": dense_g, "loss": loss,
                        "tokens_per_sec": dense_rps * tokens}
    return out


# phase 18: tensor parallelism and experts (items 7.2 and 7.3) at
# GPT-2-small's full width (config 5's round, dropout 0): gloo ranks on
# cuda:0 as (clients 1) x (model 2), (clients 1) x (expert 2) on the MoE
# model (4 experts on every other block), (seq 2) x (model 2) under ring,
# and gpt2_train on (model 2) x (expert 2)
MOE_D = 209_466_625
MOE_EXPERTS = 4
MOE_ARGS = ["--n_experts", str(MOE_EXPERTS)]
TP_ARGS = ["--model_devices", "2", "--num_devices", "1"]
EP_ARGS = MOE_ARGS + ["--expert_devices", "2", "--num_devices", "1"]
MP_ROUNDS = 2
MP_TIMED_ROUNDS = 2
MP_GRID_ROUNDS = 2
# the sparse dispatch against dense dispatch at capacity E on the card
# (the two formulations add in another order):
# |sparse - dense| <= MOE_DISPATCH_RTOL * max|dense|
MOE_DISPATCH_RTOL = 1e-5


def file_barrier(tmp: str, name: str, i: int, n: int = 4,
                 timeout: float = 240.0) -> None:
    """Wait until ``n`` processes have reached the barrier ``name`` (each
    writes ``<tmp>/<name>.<i>``)."""
    open(os.path.join(tmp, f"{name}.{i}"), "w").close()
    t = time.perf_counter()
    while sum(os.path.exists(os.path.join(tmp, f"{name}.{j}"))
              for j in range(n)) < n:
        assert time.perf_counter() - t < timeout, f"barrier {name} timed out"
        time.sleep(0.05)


# phase 18's pairs: name -> (flags, grid keywords, reference, inner axis)
MP_LEGS = {"tp": (TP_ARGS, {"model_devices": 2}, "dense", "model"),
           "ep": (EP_ARGS, {"expert_devices": 2, "n_experts": MOE_EXPERTS},
                  "moe", "expert")}


def _pair(i: int, tmp: str, legs: dict, rounds: int, timed: int) -> dict:
    """Stage 1 of phases 18 and 19: ranks 0-1 run the first of ``legs``,
    ranks 2-3 the second, each pair as (clients 1) x (2 on its inner
    axis). Round 1's summed gradient and losses against the one-rank
    round's (``tmp/<reference>_*``), ``rounds`` finite rounds with 2 / 1 /
    8 launches each, the weights' hash and the peak memory; then each pair
    times ``timed`` rounds while the other waits at a barrier."""
    import torch.distributed as dist

    from commefficient_torch.parallel import make_client_group

    leg = list(legs)[i // 2]
    extra, grid_kw, ref_name, axis = legs[leg]
    t0 = time.perf_counter()
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store_{leg}",
                            rank=i % 2, world_size=2)
    rec = {"leg": leg, "launches": [], "losses": [], "s": {}}
    try:
        dev = seq_device()
        torch.cuda.reset_peak_memory_stats()
        g = make_client_group(GPT2_W, 1, dev, **grid_kw)
        inner = getattr(g, axis)
        assert (g.rank, g.size, inner.rank, inner.size) == (0, 1, i % 2, 2)
        fm, one = build_seq_gpt2(extra, g)
        assert g.axis(axis) is inner and axis in (
            fm.worker_config.model_axis, fm.worker_config.pp_axis,
            fm.worker_config.expert_axis), fm.worker_config
        rec["s"]["build"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = torch.from_numpy(np.load(os.path.join(
            tmp, f"{ref_name}_g.npy"))).to(dev)
        ref_loss = np.load(os.path.join(tmp, f"{ref_name}_loss.npy"))
        scale = float(ref.abs().max())
        for r in range(rounds):
            grads = []
            kernels.reset_launch_counts()
            with summed_gradient(grads):
                loss = one(seq_batch(r))[0]
            torch.cuda.synchronize()
            rec["launches"].append(kernels.launch_counts())
            rec["losses"].append(loss.tolist())
            assert np.all(np.isfinite(loss)), (leg, r, loss)
            if r == 0:
                err = (grads[0] - ref).abs()
                bound = SEQ_GRAD_ATOL * scale + SEQ_GRAD_RTOL * ref.abs()
                rec["grad_max_abs_err"] = float(err.max())
                rec["grad_scale"] = scale
                rec["grad_within"] = bool((err <= bound).all())
                rec["loss_max_rel_err"] = float(np.max(
                    np.abs(loss - ref_loss) / np.abs(ref_loss)))
            del grads
        rec["w_hash"] = w_hash(fm)
        rec["peak_memory_GB"] = torch.cuda.max_memory_allocated() / 1e9
        rec["s"]["rounds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        batch = seq_batch(rounds)
        for name in legs:
            file_barrier(tmp, f"timed_{name}", i)
            if name == leg:
                dist.barrier()
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(timed):
                    one(batch)
                torch.cuda.synchronize()
                rec["rounds_per_sec"] = timed / (time.perf_counter() - t)
        file_barrier(tmp, "timed_done", i)
        rec["s"]["timed"] = time.perf_counter() - t0
        del fm, one
        release_card()
    finally:
        dist.destroy_process_group()
    return rec


def _grid4(i: int, tmp: str, extra, grid_kw: dict, rounds: int,
           store: str = "grid") -> dict:
    """Stage 2 of phases 18 and 19 on all four ranks, the grid
    ``grid_kw`` of one tuple index (process rank ``tuple_index``), its
    process group at ``tmp/store_<store>``: ``rounds`` finite rounds with
    2 / 1 / 8 launches each and the weights' hash."""
    import torch.distributed as dist

    from commefficient_torch.parallel import make_client_group, tuple_index

    n = {k: grid_kw.get(k, 1) for k in ("seq_devices", "model_devices",
                                        "pipeline_devices")}
    rank = tuple_index(i, 1, 1, n["seq_devices"], n["model_devices"],
                       n_stage=n["pipeline_devices"])
    dist.init_process_group("gloo",
                            init_method=f"file://{tmp}/store_{store}",
                            rank=rank, world_size=4)
    rec = {"rank": rank, "launches": [], "losses": []}
    try:
        t0 = time.perf_counter()
        g = make_client_group(GPT2_W, 1, seq_device(), **grid_kw)
        assert g.process_rank == rank and g.inner_size == 4
        fm, one = build_seq_gpt2(extra, g)
        rec["s"] = {"build": time.perf_counter() - t0}
        t0 = time.perf_counter()
        for r in range(rounds):
            kernels.reset_launch_counts()
            loss = one(seq_batch(r))[0]
            torch.cuda.synchronize()
            rec["launches"].append(kernels.launch_counts())
            rec["losses"].append(loss.tolist())
            assert np.all(np.isfinite(loss)), (r, loss)
        rec["w_hash"] = w_hash(fm)
        rec["s"]["rounds"] = time.perf_counter() - t0
        del fm, one
        release_card()
    finally:
        dist.destroy_process_group()
    return rec


def _cli(i: int, tmp: str, world: int, extra) -> dict:
    """``gpt2_train`` with the flags ``extra`` on ``world`` gloo ranks on
    ``cuda:0`` (dropout 0.1, full width and depth), a fraction of an
    epoch of the synthetic PersonaChat, and the val pass; its tokens/sec
    over its rounds, from the engine's first submit to its last drain
    (the rounds' valid examples x candidates x tokens)."""
    from commefficient_torch import gpt2_train
    from commefficient_torch.federated.engine import PipelinedRoundEngine

    timing = {"tokens": 0.0, "t0": None, "t1": None}
    submit, drain = PipelinedRoundEngine.submit, PipelinedRoundEngine.drain

    def timed_submit(self, batch):
        if timing["t0"] is None:
            torch.cuda.synchronize()
            timing["t0"] = time.perf_counter()
        ids = np.asarray(batch["input_ids"])
        timing["tokens"] += float(np.asarray(batch["mask"]).sum()) \
            * ids.shape[-2] * ids.shape[-1]
        return submit(self, batch)

    def timed_drain(self):
        out = drain(self)
        torch.cuda.synchronize()
        timing["t1"] = time.perf_counter()
        return out

    torch.cuda.reset_peak_memory_stats()
    os.environ.update(RANK=str(i), WORLD_SIZE=str(world), LOCAL_RANK="0",
                      LOCAL_WORLD_SIZE=str(world),
                      COMMEFFICIENT_SYNTHETIC_CLIENTS="8",
                      COMMEFFICIENT_RUN_DIR=os.path.join(tmp, "cli_run"))
    kernels.reset_launch_counts()
    with mock.patch.object(PipelinedRoundEngine, "submit", timed_submit), \
            mock.patch.object(PipelinedRoundEngine, "drain", timed_drain):
        stats = gpt2_train.train(GPT2_BASE + [
            "--dataset_dir", os.path.join(tmp, "persona"), "--num_epochs",
            "0.3", "--num_devices", "1"] + list(extra),
            init_method=f"file://{tmp}/store_cli", backend="gloo")
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        os.environ.pop(key)
    return {"stats": {k: float(v) for k, v in stats.items()},
            "launches": kernels.launch_counts(),
            "tokens_per_sec": timing["tokens"] / (timing["t1"]
                                                  - timing["t0"]),
            "peak_memory_GB": torch.cuda.max_memory_allocated() / 1e9}


def _mp_rank(i: int, tmp: str, spawned_at: float) -> None:
    """One process of phase 18: stages 1-3, its record written to
    ``tmp`` (with the seconds from its spawn, at ``spawned_at`` on the
    wall clock, to its kernels loaded)."""
    kernels.library()
    start_s = time.time() - spawned_at
    with deterministic_cudnn():
        out = {"pair": _pair(i, tmp, MP_LEGS, MP_ROUNDS, MP_TIMED_ROUNDS)}
        out["pair"]["s"]["start"] = start_s
        out["grid"] = _grid4(i, tmp, ["--seq_parallel", "ring",
                                      "--seq_devices", "2"] + TP_ARGS,
                             {"seq_devices": 2, "model_devices": 2},
                             MP_GRID_ROUNDS)
        t = time.perf_counter()
        out["cli"] = _cli(i, tmp, 4, TP_ARGS[:2] + EP_ARGS[:-2])
        out["cli"]["s"] = time.perf_counter() - t
    with open(os.path.join(tmp, f"mp{i}.json"), "w") as f:
        json.dump(out, f)


def moe_dispatch_check(card: str) -> dict:
    """Phase 18 (d), in this process: one MoE layer at full width (C 768,
    4 experts, N(0, 0.02) leaves from a seed) on one client's 4 x 256
    tokens. Sparse dispatch at capacity factor E equals dense dispatch
    (within MOE_DISPATCH_RTOL of the largest magnitude); at 1.25 the card
    keeps exactly the tokens the plain CPU computation of the same layer
    keeps, zeroes the others, and agrees with it on the kept ones (the
    tokens lean to one expert, so that it overflows)."""
    from commefficient_torch.parallel.moe import MoEMLP

    gen = torch.Generator().manual_seed(18)
    cpu = {}
    for dispatch, cf in (("dense", 1.25), ("sparse", float(MOE_EXPERTS)),
                         ("sparse", 1.25)):
        mod = MoEMLP(768, MOE_EXPERTS, dispatch=dispatch,
                     capacity_factor=cf)
        cpu[(dispatch, cf)] = mod
    with torch.no_grad():
        for name, p in cpu[("dense", 1.25)].named_parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02
                    if name in ("router", "w_fc", "w_proj")
                    else torch.zeros(p.shape))
        for mod in cpu.values():
            mod.load_state_dict(cpu[("dense", 1.25)].state_dict())
    # tokens leaning to expert 0 (its logit raised by 0.5, about one
    # standard deviation of a logit): it receives more than its capacity
    r0 = cpu[("dense", 1.25)].router.detach()[:, 0]
    x = torch.randn((GPT2_B * GPT2_C, GPT2_T, 768), generator=gen) \
        + 0.5 * r0 / torch.dot(r0, r0)
    dev = torch.device("cuda")
    with torch.no_grad():
        outs = {key: mod.to(dev)(x.to(dev))[0] for key, mod in cpu.items()}
        dense = outs[("dense", 1.25)]
        full = outs[("sparse", float(MOE_EXPERTS))]
        scale = float(dense.abs().max())
        err_full = float((full - dense).abs().max())
        assert err_full <= MOE_DISPATCH_RTOL * scale, (err_full, scale)
        sparse = outs[("sparse", 1.25)]
        kept = cpu[("sparse", 1.25)].kept_tokens(x.to(dev)).cpu()
        plain_mod = cpu[("sparse", 1.25)].to("cpu")
        plain = plain_mod(x)[0]
        plain_kept = plain_mod.kept_tokens(x)
    assert torch.equal(kept, plain_kept), "the card drops other tokens"
    zero = (sparse == 0).all(dim=-1).cpu()
    assert torch.equal(zero, ~plain_kept), "dropped tokens are not zero"
    err_kept = float((sparse.cpu() - plain).abs().max())
    assert err_kept <= MOE_DISPATCH_RTOL * float(plain.abs().max()), err_kept
    row = {"phase": "moe dispatch", "tokens": int(kept.numel()),
           "capacity": plain_mod.capacity(kept.numel()),
           "dropped": int((~kept).sum()), "full_capacity_max_abs_err":
           err_full, "dense_scale": scale, "kept_max_abs_err": err_kept,
           "card": card}
    assert 0 < row["dropped"] < row["tokens"], row
    print(json.dumps(row))
    return row


def one_rank_round(extra, rounds: int, timed: int) -> dict:
    """The one-rank GPT-2 round (``build_seq_gpt2(extra)``) in this
    process: round 1's summed gradient and losses, then ``timed`` timed
    rounds after a second, and the peak memory."""
    torch.cuda.reset_peak_memory_stats()
    tokens = GPT2_W * GPT2_B * GPT2_C * GPT2_T
    fm, one = build_seq_gpt2(extra)
    grads = []
    with summed_gradient(grads):
        loss = one(seq_batch(0))[0]
    g = grads[0].cpu().numpy()
    del grads
    one(seq_batch(1))
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(timed):
        one(seq_batch(rounds))
    torch.cuda.synchronize()
    out = {"g": g, "loss": loss,
           "tokens_per_sec": timed * tokens / (time.perf_counter() - t),
           "peak_memory_GB": torch.cuda.max_memory_allocated() / 1e9}
    del fm, one
    release_card()
    return out


def phase_tp_ep(card: str, dense_ref=None) -> dict:
    """Phase 18: GPT-2's tensor parallelism and the MoE model's expert
    parallelism at GPT-2-small's full width (768, 12 heads; 4 experts on
    every other block, d = 209,466,625, Tn = 419) and config 5's round
    (4 clients x 2 examples x 2 candidates x 256 tokens, the 5 x 500,000
    sketch, k = 50,000), dropout 0 and cuDNN deterministic, on gloo ranks
    on ``cuda:0`` (two NCCL ranks cannot share a card; gloo stages every
    collective, the activation sums included, through the host):

    (a) two ranks as (clients 1) x (model 2), dense attention, full
        depth: round 1's summed gradient (after the sum times
        ``tp_scale``) within SEQ_GRAD_ATOL / SEQ_GRAD_RTOL of the
        one-rank round's, its losses within SEQ_LOSS_RTOL, MP_ROUNDS
        finite rounds, both ranks' weights bit-equal, 2 / 1 / 8 launches
        of kernels 1 / 3 / 5 a round on each rank;
    (b) four ranks as (seq 2) x (model 2) under ring: MP_GRID_ROUNDS
        finite rounds, the four ranks' weights bit-equal, 2 / 1 / 8;
    (c) two ranks as (clients 1) x (expert 2) on the MoE model, dense
        dispatch, with the aux loss: as (a) against the one-rank MoE
        round; and the six kernels against their plain versions at its
        geometry (Tn = 419), exact;
    (d) sparse dispatch on one rank (``moe_dispatch_check``);
    (e) ``gpt2_train --model_devices 2 --n_experts 4 --expert_devices
        2`` on four ranks as (model 2) x (expert 2), the MoE model at full
        depth: a finite val NLL alike on every rank, the headline kernels
        launched, its tokens/sec over its rounds;
    (f) tokens/sec of (a), (c) and (e) (each with the card to itself)
        beside the one-rank rounds' (data, no claim).

    ``dense_ref``: phase 17's one-rank round (its summed gradient, losses
    and tokens/sec), the same round as (a)'s reference; None computes
    it here."""
    import multiprocessing as mp

    release_card()
    t = time.perf_counter()
    tokens = GPT2_W * GPT2_B * GPT2_C * GPT2_T
    out = {"phase": "tensor and expert parallelism", "card": card}
    with tempfile.TemporaryDirectory() as tmp, deterministic_cudnn():
        one_rank, refs = {}, {}
        for name, extra in (("dense", []), ("moe", MOE_ARGS)):
            if name == "dense" and dense_ref is not None:
                refs[name] = dense_ref
                one_rank[name] = {
                    "tokens_per_sec": dense_ref["tokens_per_sec"],
                    "from": "phase 17"}
            else:
                refs[name] = one_rank_round(extra, MP_ROUNDS,
                                            MP_TIMED_ROUNDS)
                one_rank[name] = {k: refs[name][k] for k in (
                    "tokens_per_sec", "peak_memory_GB")}
            np.save(os.path.join(tmp, f"{name}_g.npy"), refs[name]["g"])
            np.save(os.path.join(tmp, f"{name}_loss.npy"),
                    refs[name]["loss"])
        out["one_rank"] = one_rank
        out["moe_kernels"] = check_kernels(card, MOE_D, 500_000, 5, 0, 18,
                                           "gpt2 moe", False, k=50_000)
        for name, row in out["moe_kernels"].items():
            print(json.dumps({"phase": "moe kernels", "geometry": "gpt2 moe",
                              "Tn": -(-MOE_D // 500_096), "name": name,
                              **row}))
        out["dispatch"] = moe_dispatch_check(card)
        held = release_card()
        print("phase 18: this process holds " + json.dumps(held)
              + " on the card before its ranks start")
        out["one_rank_s"] = time.perf_counter() - t
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_mp_rank, args=(i, tmp, time.time()))
                 for i in range(4)]
        for pr in procs:
            pr.start()
        for pr in procs:
            pr.join(max(1.0, 420 - (time.perf_counter() - t)))
        alive = [pr for pr in procs if pr.is_alive()]
        for pr in alive:
            pr.kill()
            pr.join()
        assert not alive, "phase 18 ranks timed out"
        assert all(pr.exitcode == 0 for pr in procs), \
            [pr.exitcode for pr in procs]
        ranks = []
        for i in range(4):
            with open(os.path.join(tmp, f"mp{i}.json")) as f:
                ranks.append(json.load(f))

    def nonzero(counts):
        return {k: v for k, v in counts.items() if v}

    pairs = {"tp": [r["pair"] for r in ranks[:2]],
             "ep": [r["pair"] for r in ranks[2:]]}
    for leg, pair in pairs.items():
        for i, rec in enumerate(pair):
            assert rec["grad_within"], (leg, i, rec["grad_max_abs_err"],
                                        rec["grad_scale"])
            assert rec["loss_max_rel_err"] <= SEQ_LOSS_RTOL, \
                (leg, i, rec["loss_max_rel_err"])
            for counts in rec["launches"]:
                assert nonzero(counts) == HEADLINE_PER_ROUND, \
                    (leg, i, counts)
        assert pair[0]["w_hash"] == pair[1]["w_hash"], \
            f"{leg}: the ranks' weights differ"
        assert pair[0]["losses"] == pair[1]["losses"], leg
    grids = [r["grid"] for r in ranks]
    assert sorted(g["rank"] for g in grids) == [0, 1, 2, 3]
    assert len({g["w_hash"] for g in grids}) == 1, \
        "seq x model: the four ranks' weights differ"
    for g in grids:
        for counts in g["launches"]:
            assert nonzero(counts) == HEADLINE_PER_ROUND, (g["rank"], counts)
    cli = [r["cli"] for r in ranks]
    keys = ("val_nll", "val_acc", "val_ppl")
    for c in cli:
        assert np.isfinite(c["stats"]["val_nll"]), c
        assert all((c["launches"][k] > 0) == (k in HEADLINE_KERNELS)
                   for k in c["launches"]), c["launches"]
    assert len({tuple(c["stats"][k] for k in keys) for c in cli}) == 1, cli
    out.update(
        grad_max_abs_err={leg: max(p["grad_max_abs_err"] for p in pair)
                          for leg, pair in pairs.items()},
        grad_scale={leg: pair[0]["grad_scale"]
                    for leg, pair in pairs.items()},
        loss_max_rel_err={leg: max(p["loss_max_rel_err"] for p in pair)
                          for leg, pair in pairs.items()},
        launches_per_round_per_rank=nonzero(pairs["tp"][0]["launches"][0]),
        peak_memory_GB_rank={leg: max(p["peak_memory_GB"] for p in pair)
                             for leg, pair in pairs.items()},
        cli={**cli[0]["stats"], "peak_memory_GB_rank": max(
            c["peak_memory_GB"] for c in cli)},
        tokens_per_sec={
            "one rank": one_rank["dense"]["tokens_per_sec"],
            "one rank moe": one_rank["moe"]["tokens_per_sec"],
            "clients 1 x model 2": pairs["tp"][0]["rounds_per_sec"] * tokens,
            "clients 1 x expert 2 moe":
                pairs["ep"][0]["rounds_per_sec"] * tokens,
            "model 2 x expert 2 moe (gpt2_train)":
                cli[0]["tokens_per_sec"]},
        stage_s_rank0={"pair": ranks[0]["pair"]["s"],
                       "ep pair": ranks[2]["pair"]["s"],
                       "seq x model": grids[0]["s"], "cli": cli[0]["s"]},
        wall_s=time.perf_counter() - t,
        note="gloo stages the gradient sums (497.8 MB, 837.9 MB for the "
             "MoE model) and the activation sums through the host: these "
             "rates measure nothing of NVLink")
    print(json.dumps({k: v for k, v in out.items() if k != "moe_kernels"}))
    # the one-rank MoE round, which phase 19 holds its pipelined MoE round
    # to
    out["moe_ref"] = refs["moe"]
    return out


# phase 19: the pipeline (item 7.4) at GPT-2-small's full width (config
# 5's round, dropout 0): gloo ranks on cuda:0 as (clients 1) x (stage 2)
# on GPT-2 and on the MoE model, (stage 2) x (model 2), and gpt2_train on
# (stage 2)
PP_ARGS = ["--pipeline_devices", "2", "--pp_microbatches", "2",
           "--num_devices", "1"]
# the MoE aux is a per-microbatch estimator: the one-rank round's at one
# microbatch
PP_MOE_ARGS = MOE_ARGS + ["--pipeline_devices", "2", "--pp_microbatches",
                          "1", "--num_devices", "1"]
PP_LEGS = {"pp": (PP_ARGS, {"pipeline_devices": 2}, "dense", "stage"),
           "pp_moe": (PP_MOE_ARGS, {"pipeline_devices": 2,
                                    "n_experts": MOE_EXPERTS}, "moe",
                      "stage")}
PP_ROUNDS = 2
PP_TIMED_ROUNDS = 2
PP_GRID_ROUNDS = 2


def _pp_rank(i: int, tmp: str, spawned_at: float) -> None:
    """One process of phase 19: the pairs, the (stage 2) x (model 2) and
    (seq 2) x (stage 2) grids, then ``gpt2_train --pipeline_devices 2`` on
    ranks 0-1; its record written to ``tmp``."""
    kernels.library()
    start_s = time.time() - spawned_at
    with deterministic_cudnn():
        out = {"pair": _pair(i, tmp, PP_LEGS, PP_ROUNDS, PP_TIMED_ROUNDS)}
        out["pair"]["s"]["start"] = start_s
        out["grid"] = _grid4(i, tmp, TP_ARGS[:2] + PP_ARGS,
                             {"model_devices": 2, "pipeline_devices": 2},
                             PP_GRID_ROUNDS)
        out["ring"] = _grid4(i, tmp, ["--seq_parallel", "ring",
                                      "--seq_devices", "2"] + PP_ARGS,
                             {"seq_devices": 2, "pipeline_devices": 2},
                             PP_GRID_ROUNDS, store="ring")
        if i < 2:
            t = time.perf_counter()
            out["cli"] = _cli(i, tmp, 2, PP_ARGS)
            out["cli"]["s"] = time.perf_counter() - t
    with open(os.path.join(tmp, f"pp{i}.json"), "w") as f:
        json.dump(out, f)


def phase_pp(card: str, dense_ref=None, moe_ref=None) -> dict:
    """Phase 19: GPT-2's pipeline at GPT-2-small's full width and depth
    (12 x 768, 12 heads; d = 124,444,417) and on phase 18's MoE model (4
    experts on every other block: 6 layers a stage, the same dense/MoE
    pattern on both), config 5's round (4 clients x 2 examples x 2
    candidates x 256 tokens, the 5 x 500,000 sketch, k = 50,000),
    dropout 0 and cuDNN deterministic, on gloo ranks on ``cuda:0`` (gloo
    stages the hops and the gradient sum over ``stage`` through the
    host):

    (a) two ranks as (clients 1) x (stage 2), ``--pp_microbatches 2``:
        round 1's summed gradient within SEQ_GRAD_ATOL / SEQ_GRAD_RTOL of
        the one-rank round's and its losses within SEQ_LOSS_RTOL,
        PP_ROUNDS finite rounds, both ranks' weights bit-equal, 2 / 1 / 8
        launches of kernels 1 / 3 / 5 a round on each rank;
    (b) meanwhile two more ranks as (clients 1) x (stage 2) on the MoE
        model with its aux at ``--pp_microbatches 1``: as (a) against the
        one-rank MoE round; then each pair's PP_TIMED_ROUNDS timed rounds
        with the card to itself;
    (c) four ranks as (stage 2) x (model 2), then as (seq 2) x (stage 2)
        under ring attention: PP_GRID_ROUNDS finite rounds each, the four
        ranks' weights bit-equal, 2 / 1 / 8;
    (d) ``python -m commefficient_torch.gpt2_train --pipeline_devices 2``
        on two ranks at full depth: a finite val NLL alike on both ranks,
        its tokens/sec timed inside ``gpt2_train``;
    (e) tokens/sec of (a), (b) and (d) beside the one-rank rounds', and
        the peak memory a rank (data, no claim).

    ``dense_ref`` / ``moe_ref``: phase 17's and phase 18's one-rank rounds
    (summed gradient, losses, tokens/sec); None computes them here."""
    import multiprocessing as mp

    release_card()
    t = time.perf_counter()
    tokens = GPT2_W * GPT2_B * GPT2_C * GPT2_T
    out = {"phase": "pipeline", "card": card}
    with tempfile.TemporaryDirectory() as tmp, deterministic_cudnn():
        refs = {"dense": dense_ref, "moe": moe_ref}
        for name, extra in (("dense", []), ("moe", MOE_ARGS)):
            if refs[name] is None:
                refs[name] = one_rank_round(extra, PP_ROUNDS,
                                            PP_TIMED_ROUNDS)
            np.save(os.path.join(tmp, f"{name}_g.npy"), refs[name]["g"])
            np.save(os.path.join(tmp, f"{name}_loss.npy"),
                    refs[name]["loss"])
        held = release_card()
        print("phase 19: this process holds " + json.dumps(held)
              + " on the card before its ranks start")
        out["one_rank_s"] = time.perf_counter() - t
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_pp_rank, args=(i, tmp, time.time()))
                 for i in range(4)]
        for pr in procs:
            pr.start()
        for pr in procs:
            pr.join(max(1.0, 300 - (time.perf_counter() - t)))
        alive = [pr for pr in procs if pr.is_alive()]
        for pr in alive:
            pr.kill()
            pr.join()
        assert not alive, "phase 19 ranks timed out"
        assert all(pr.exitcode == 0 for pr in procs), \
            [pr.exitcode for pr in procs]
        ranks = []
        for i in range(4):
            with open(os.path.join(tmp, f"pp{i}.json")) as f:
                ranks.append(json.load(f))

    def nonzero(counts):
        return {k: v for k, v in counts.items() if v}

    pairs = {"pp": [r["pair"] for r in ranks[:2]],
             "pp_moe": [r["pair"] for r in ranks[2:]]}
    for leg, pair in pairs.items():
        for i, rec in enumerate(pair):
            assert rec["grad_within"], (leg, i, rec["grad_max_abs_err"],
                                        rec["grad_scale"])
            assert rec["loss_max_rel_err"] <= SEQ_LOSS_RTOL, \
                (leg, i, rec["loss_max_rel_err"])
            for counts in rec["launches"]:
                assert nonzero(counts) == HEADLINE_PER_ROUND, \
                    (leg, i, counts)
        assert pair[0]["w_hash"] == pair[1]["w_hash"], \
            f"{leg}: the stage ranks' weights differ"
        assert pair[0]["losses"] == pair[1]["losses"], leg
    for key, what in (("grid", "stage x model"), ("ring", "seq x stage")):
        grids = [r[key] for r in ranks]
        assert sorted(g["rank"] for g in grids) == [0, 1, 2, 3]
        assert len({g["w_hash"] for g in grids}) == 1, \
            f"{what}: the four ranks' weights differ"
        for g in grids:
            for counts in g["launches"]:
                assert nonzero(counts) == HEADLINE_PER_ROUND, \
                    (what, g["rank"], counts)
    cli = [r["cli"] for r in ranks[:2]]
    keys = ("val_nll", "val_acc", "val_ppl")
    for c in cli:
        assert np.isfinite(c["stats"]["val_nll"]), c
        assert all((c["launches"][k] > 0) == (k in HEADLINE_KERNELS)
                   for k in c["launches"]), c["launches"]
    assert len({tuple(c["stats"][k] for k in keys) for c in cli}) == 1, cli
    out.update(
        grad_max_abs_err={leg: max(p["grad_max_abs_err"] for p in pair)
                          for leg, pair in pairs.items()},
        grad_scale={leg: pair[0]["grad_scale"]
                    for leg, pair in pairs.items()},
        loss_max_rel_err={leg: max(p["loss_max_rel_err"] for p in pair)
                          for leg, pair in pairs.items()},
        launches_per_round_per_rank=nonzero(pairs["pp"][0]["launches"][0]),
        peak_memory_GB_rank={leg: max(p["peak_memory_GB"] for p in pair)
                             for leg, pair in pairs.items()},
        cli={**cli[0]["stats"], "peak_memory_GB_rank": max(
            c["peak_memory_GB"] for c in cli)},
        tokens_per_sec={
            "one rank": refs["dense"]["tokens_per_sec"],
            "one rank moe": refs["moe"]["tokens_per_sec"],
            "clients 1 x stage 2": pairs["pp"][0]["rounds_per_sec"] * tokens,
            "clients 1 x stage 2 moe":
                pairs["pp_moe"][0]["rounds_per_sec"] * tokens,
            "stage 2 (gpt2_train)": cli[0]["tokens_per_sec"]},
        stage_s_rank0={"pair": ranks[0]["pair"]["s"],
                       "moe pair": ranks[2]["pair"]["s"],
                       "stage x model": ranks[0]["grid"]["s"],
                       "seq x stage": ranks[0]["ring"]["s"],
                       "cli": cli[0]["s"]},
        wall_s=time.perf_counter() - t,
        note="gloo stages the hops and the gradient sums (497.8 MB, 837.9 "
             "MB for the MoE model) through the host: these rates measure "
             "nothing of NVLink")
    print(json.dumps(out))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel-times", nargs="*", metavar="NAME",
                    help="time the accumulate pair, the query, the count "
                    "pass, the fused epilogue and the descent only (the "
                    "rows of the NAMEs given, else all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    if args.kernel_times is not None:
        return kernel_times(card, args.kernel_times)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")

    t_build = time.perf_counter()
    path, log = kernels.build()
    kernels.library()
    print(f"built {path.name} in {time.perf_counter() - t_build:.1f} s")
    for line in log.splitlines():
        if any(s in line for s in ("Compiling entry", "registers",
                                   "spill", "smem")):
            print("  ptxas: " + line.strip().removeprefix("ptxas info    : "))

    bw, flops, iops = peaks(card)
    print(f"peaks: {bw / 1e12:.2f} TB/s, {flops / 1e12:.1f} T float32 op/s, "
          f"{iops / 1e12:.2f} T int32 op/s (64 lanes x "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs "
          "x the max SM clock)")
    rows = {}
    for label, geom, timed in (
            ("headline", (6_568_640, 500_000, 5, 0, 0), True),
            ("ragged", (50_003, 3_001, 4, 2, 7), False),
            ("ragged-odd", (50_003, 3_001, 5, 0, 8), False),
            ("ragged-tile", (9_001, 700, 5, 0, 9), False)):
        d, c, r, t0, seed = geom
        res = check_kernels(card, d, c, r, t0, seed, label, timed)
        for name, row in res.items():
            line = {"phase": "kernels", "geometry": label, "name": name,
                    **row, "check_launches": kernels.launch_counts()[name]}
            print(json.dumps(line))
            if timed:
                rows[name] = row
    print(json.dumps({"kernels_checked": [k.name for k in kernels.KERNELS]}))
    wall = {"3 kernels": time.perf_counter() - t_build}

    t = time.perf_counter()
    counts, rps, split = phase_rounds()
    wall["4 headline"] = time.perf_counter() - t
    t = time.perf_counter()
    opt_counts, opt_rps, opt_prof = phase_opt_in(rps)
    wall["5 opt-in"] = time.perf_counter() - t
    t = time.perf_counter()
    phase_cv_train()
    wall["6 cv_train"] = time.perf_counter() - t
    t = time.perf_counter()
    modes = phase_modes(card)
    wall["7 other modes"] = time.perf_counter() - t
    t = time.perf_counter()
    lifecycle = phase_lifecycle(card)
    wall["8 lifecycle"] = time.perf_counter() - t
    t = time.perf_counter()
    gpt2 = phase_gpt2(card)
    wall["9 gpt2"] = time.perf_counter() - t
    t = time.perf_counter()
    cv = phase_cv_models(card)
    wall["10 cv models"] = time.perf_counter() - t
    t = time.perf_counter()
    multi = phase_multi(card, rps, gpt2["legs"]["gpt2 f32"])
    wall["11 multi-GPU and HF"] = time.perf_counter() - t
    t = time.perf_counter()
    obs = phase_observability(card)
    wall["12 observability and guards"] = time.perf_counter() - t
    t = time.perf_counter()
    part = phase_participation(card)
    wall["13 participation"] = time.perf_counter() - t
    t = time.perf_counter()
    offload = phase_offload(card)
    wall["14 client state off the card"] = time.perf_counter() - t
    t = time.perf_counter()
    service = phase_service(card)
    wall["15 open-world service"] = time.perf_counter() - t
    t = time.perf_counter()
    grid = phase_grid(card)
    wall["16 2-D plane"] = time.perf_counter() - t
    t = time.perf_counter()
    seq = phase_seq(card)
    wall["17 sequence parallelism"] = time.perf_counter() - t
    t = time.perf_counter()
    dense_ref = seq.pop("dense_ref")
    tp_ep = phase_tp_ep(card, dense_ref)
    wall["18 tensor and expert parallelism"] = time.perf_counter() - t
    t = time.perf_counter()
    pp = phase_pp(card, dense_ref, tp_ep.pop("moe_ref"))
    wall["19 pipeline"] = time.perf_counter() - t
    print("phase wall seconds (phase 3 includes the build): " + json.dumps(
        {k: round(v, 2) for k, v in wall.items()}))

    # launches: each kernel from the timed window of the path that runs it
    launches = {**{k: counts[k] for k in HEADLINE_KERNELS},
                **{k: opt_counts[k] for k in OPT_IN_KERNELS}}
    # the sharded path (phase 11): the launches of rank 1 (t0 > 0) in the
    # 2-rank gloo round (the epilogue: of its --fused_epilogue round), the
    # largest error at t0 > 0 over both geometries (kernels 2 and 6 are
    # not on that path)
    gloo = multi["gloo"]

    def sharded(name):
        got = gloo["launches_rank1_fused_epilogue" if name == "fused_epilogue"
                   else "launches_rank1"]
        errs = [g["max_abs_err"][name] for g in multi["kernels"].values()
                if name in g["max_abs_err"]]
        return {"launches_per_round_per_rank": got.get(name, 0),
                "max_abs_err": max(errs) if errs else None}

    # the 2-D plane (phase 16): rank 3's launches a round (t0 = 12)
    grid_launches = {**grid["launches_per_round_rank3"],
                     "fused_epilogue": grid[
                         "launches_per_round_rank3_fused"].get(
                         "fused_epilogue", 0)}
    summary = {"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": launches[k.name],
         **{key: rows[k.name][key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")}, "sharded": sharded(k.name),
         "grid_2d_launches_per_round_per_rank": grid_launches.get(k.name, 0),
         "seq_launches_per_round_per_rank": seq[
             "launches_per_round_per_rank"].get(k.name, 0),
         "tp_ep_launches_per_round_per_rank": tp_ep[
             "launches_per_round_per_rank"].get(k.name, 0),
         "pp_launches_per_round_per_rank": pp[
             "launches_per_round_per_rank"].get(k.name, 0),
         "moe_geometry_max_abs_err": tp_ep["moe_kernels"][k.name][
             "max_abs_err"]}
        for k in kernels.KERNELS]}
    print(json.dumps({"rounds_per_sec": rps,
                      "opt_in_rounds_per_sec": opt_rps,
                      "main_path_rounds": TIMED_ROUNDS, **split,
                      "modes_rounds_per_sec": {
                          k: v["rounds_per_sec"] for k, v in modes.items()
                          if "rounds_per_sec" in v},
                      "batchnorm_rounds_per_sec":
                          lifecycle["batchnorm"]["rounds_per_sec"],
                      "gpt2_tokens_per_sec": {
                          k: v["tokens_per_sec"]
                          for k, v in gpt2["legs"].items()},
                      "femnist_images_per_sec": {
                          k: v["images_per_sec"]
                          for k, v in cv["legs"].items()},
                      "imagenet_images_per_sec":
                          cv["imagenet"]["images_per_sec"],
                      "nccl_world1_rounds_per_sec": {
                          k: v["rounds_per_sec"]
                          for k, v in multi["nccl"]["legs"].items()},
                      "hf_gpt2_tokens_per_sec": multi["hf"]["tokens_per_sec"],
                      "observability_on_off_median": {
                          row["leg"]: {
                              k: row[f"{k}_ratio"]["median"]
                              for k in ("telemetry", "guards")}
                          for row in obs["costs"]},
                      "participation_on_off_median": {
                          row["leg"]: row["on_off_ratio"]["median"]
                          for row in part["costs"]},
                      "participation_gpt2_tokens_per_sec":
                          part["gpt2"]["tokens_per_sec"],
                      "offload_population_rounds_per_sec":
                          offload["population"]["rounds_per_sec"],
                      "offload_large_rounds_per_sec":
                          offload["large"]["rounds_per_sec"],
                      "service_served_over_solo":
                          service["headline"]["served_over_solo"],
                      "service_compactions":
                          service["disk"]["compactions"],
                      "service_wall_s": service["wall_s"],
                      "grid_2d_rounds_per_sec_median":
                          grid["rounds_per_sec_median"],
                      "seq_tokens_per_sec": seq["tokens_per_sec"],
                      "tp_ep_tokens_per_sec": tp_ep["tokens_per_sec"],
                      "pp_tokens_per_sec": pp["tokens_per_sec"],
                      **{"opt_in_" + k: v for k, v in opt_prof.items()}}))
    print(json.dumps(summary))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
