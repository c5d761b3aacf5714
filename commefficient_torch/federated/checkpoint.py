"""Checkpoint save/load and the run state for ``--resume``: the port of
``commefficient_tpu/federated/checkpoint.py``, in the JAX package's
``.npz`` format (plain numpy; keys '/'-joined paths).

- ``save_checkpoint`` / ``load_checkpoint``: the final weights, keys
  ``params/<flax path>`` (the flax layout of each leaf,
  ``convert.flax_from_port``) and ``model_state/<path>`` (the BatchNorm
  running statistics). The JAX package's ``load_checkpoint`` reads the
  port's file and the other way round. ``load_matching`` copies such a
  file's leaves into a fresh tree where path and shape match
  (``--finetune``).
- ``save_run_state`` / ``load_run_state``: everything a bit-exact restart
  needs, at an epoch boundary or mid-epoch (the sampler's position and
  the partial epoch accumulators), with a CRC32 content checksum in
  ``meta_json``, written atomically (``.tmp.npz`` + ``os.replace``). The
  weights, the download accounting's planes and ``acct/prev_ps`` are
  stored in the flat ``(d,)`` view whatever the resident layout, so a
  chunked and a flat run restore each other's files.
- ``--resume auto`` (``find_resume_checkpoint``) takes the newest run
  state that reads and checksums clean, skipping corrupt candidates and
  never a ``.tmp.npz``; ``--keep_checkpoints N`` prunes
  (``prune_run_states``), never a file that a ``*.pin`` lease names
  (``pinned_run_states``: a serving replica's, ``federated/serving.py``).

The run state holds the state the port has: ``ps_weights``,
``client/{velocities,errors,weights}``, ``model_state/*``,
``server/{velocity,error}``, ``np_rng/keys``, the ``--client_dropout``
stream (``drop_rng/*``, saved on every run as the JAX package saves it),
the download accounting (``acct/*``), the participation layer's state
(``part/*`` and meta ``participation``: the fault RNG, the counters and
ledgers, each pending straggler's and buffered async contribution's held
sum; under ``--server_shard`` the held partial sums are gathered to the
JAX package's ``(n, ...)`` stack and each rank takes its own back, so
held sums restore on the plane and group size that saved them), the
sampler's ``retry`` / ``quarantined`` with a mid-epoch position, the
churn layer's masks and RNG (``pop/*`` and meta ``population``; on the
disk tier the row directory rides the ``.rows`` snapshot's meta, and the
save flushes retired rows and compacts before the snapshot), and the
meta. A run state with participation state loaded into a run without the
layer warns and ignores it; a fault run resumed from a state without it
warns and starts the schedule from its seed; churn state mismatches
warn the same way. Over a client group every
rank joins the save and rank 0 writes: the sharded server's dense velocity and error are
all-gathered to the full ``(d,)`` view, and the quantized collectives'
carries to the JAX package's global layouts (``server/qres`` stacked
``(n, ...)`` over the ranks, ``server/dres`` the gathered tiles); on
restore each rank takes its slice. A replicated run state restores into
the sharded plane and the other way round; a carry the file lacks, or
holds at another group size, restarts from zero with a warning (an
error-feedback remainder may). The device generator (DP noise) is saved under
the port's own key, ``torch_rng/state``: the JAX package's ``rng`` holds
JAX key data, which a JAX file's restore in the port ignores (and refuses
under ``--dp``, whose noise streams differ); the JAX package's restore
reads ``rng``, so it does not restore a port run state. A file that
carries a plane the port does not have (the per-axis ``server/qres.*`` /
``server/dres.*``) raises ``NotImplementedError`` naming its ROADMAP
item.

Client rows follow their tier (``federated/host_state.py``). The ``hbm``
and ``host`` tiers store ``client/*`` in the archive (the host tier after
a drain of its worker). The disk tier snapshots its row files beside the
archive as ``<name>.rows/`` (a sparse copy with logical-content CRCs, the
per-row CRC sidecars and ``store.json``; rank 0 writes it, tmp directory
and rename, before the ``.npz``), records the snapshot in meta
``client_store``, and the storage-fault injector's RNG and per-row failure
counts as ``io/*`` with meta ``io_fault``: the JAX package's layout, so
either package restores the other's disk-tier run state. A restore
crosses tiers: full arrays are written into a disk-tier store
(``write_full``), and a snapshot is lifted into full arrays for the
``hbm`` and ``host`` tiers (``read_snapshot_member``). ``--resume auto``
skips a candidate whose ``.rows`` snapshot is missing or fails its CRC,
and ``--keep_checkpoints`` prunes a run state's ``.rows`` with it.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from commefficient_torch.config import ITEM_MULTI_2D

# run-state planes of the JAX package that the port does not have yet,
# with the ROADMAP item that ports each
_UNPORTED_PLANES = (
    ("server/qres.", ITEM_MULTI_2D),
    ("server/dres.", ITEM_MULTI_2D),
)


def _read_npz(path: str) -> Dict[str, np.ndarray]:
    """Every array of an ``.npz``; a truncated or bit-rotted file raises one
    ``RuntimeError`` that says so (a missing one ``FileNotFoundError``)."""
    try:
        size = os.path.getsize(path)
    except OSError:
        size = -1
    try:
        with np.load(path) as data:
            return {k: data[k] for k in data.files}
    except FileNotFoundError:
        raise
    except Exception as e:  # zipfile.BadZipFile, ValueError, EOFError, OSError
        raise RuntimeError(
            f"checkpoint corrupt or truncated ({path}, {size} bytes): "
            f"{type(e).__name__}: {e}; try an earlier run_state or "
            f"--resume auto") from e


def _content_checksum(arrays: Dict[str, np.ndarray]) -> int:
    """CRC32 over every array's name, dtype and raw bytes, in sorted key
    order (``meta_json``, which carries the checksum, excluded): the JAX
    package's checksum, value for value."""
    crc = 0
    for key in sorted(arrays):
        if key == "meta_json":
            continue
        a = np.ascontiguousarray(arrays[key])
        crc = zlib.crc32(key.encode(), crc)
        crc = zlib.crc32(str(a.dtype).encode(), crc)
        crc = zlib.crc32(a, crc)
    return crc


def _verify_checksum(flat: Dict[str, np.ndarray], meta: dict,
                     path: str) -> None:
    want = meta.get("checksum")
    if want is None:  # a file from before checksums: nothing to verify
        return
    got = _content_checksum(flat)
    if got != want:
        size = os.path.getsize(path) if os.path.exists(path) else -1
        raise RuntimeError(
            f"checkpoint corrupt or truncated ({path}, {size} bytes): "
            f"content checksum mismatch (stored {want:#010x}, computed "
            f"{got:#010x}); try an earlier run_state or --resume auto")


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        from commefficient_torch.profiling import materialize

        return materialize(x)
    return np.asarray(x)


def _flatten(tree, prefix=()):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
    else:
        out["/".join(prefix)] = _host(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_checkpoint(path: str, params, model_state=None):
    """``params``: the flax parameter tree of numpy arrays
    (``convert.flax_from_port``); ``model_state``: the port's model state
    or a flax ``batch_stats`` tree."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten({"params": params,
                     "model_state": model_state if model_state else {}})
    np.savez(path if path.endswith(".npz") else path + ".npz", **flat)


def load_checkpoint(path: str):
    """``(params, model_state)`` as nested trees of numpy arrays."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    tree = _unflatten(_read_npz(path))
    return tree.get("params", {}), tree.get("model_state", {})


def load_matching(template_params, ckpt_params):
    """Checkpoint arrays copied into the template wherever path and shape
    match: the finetune path (the backbone loads, a re-shaped head keeps
    its fresh init). Both are nested trees of numpy arrays; returns
    ``(tree, loaded count, skipped paths)``, the JAX package's
    ``load_matching``."""
    t_flat = _flatten(template_params)
    c_flat = _flatten(ckpt_params)
    loaded, skipped = 0, []
    out = {}
    for k, v in t_flat.items():
        if k in c_flat and c_flat[k].shape == v.shape:
            out[k] = c_flat[k]
            loaded += 1
        else:
            out[k] = v
            skipped.append(k)
    return _unflatten(out), loaded, skipped


def save_run_state(path: str, fed_model, optimizer, lr_scheduler,
                   next_epoch: int, totals=(0.0, 0.0),
                   mid_epoch: Optional[dict] = None) -> str:
    """The run state for ``--resume`` (see the module docstring).

    ``mid_epoch`` also captures the position inside the epoch named by
    ``next_epoch``: ``{"rounds_done": int, "sampler":
    FedSampler.get_state(), "extras": {name: np.ndarray}}``. The caller
    drains the round engine first, so the saved sampler and RNG position
    describe exactly the rounds folded into the saved state."""
    fm = fed_model
    assert getattr(fm, "_round_ctx", None) is None, (
        "save_run_state called with a round in flight (begin_round without "
        "opt.step()); drain the engine before saving")
    assert getattr(fm, "_stream_round", None) is None, (
        "save_run_state called with a host-offload row stream in flight; "
        "drain the engine before saving")
    # every scatter has landed in the streamed tier's rows
    drain = getattr(fm, "drain_client_state", None)
    if drain is not None:
        drain()
    layout = fm.layout

    def canon(t):
        # the layout-independent flat (d,) view
        return _host(layout.unchunk(t) if layout is not None else t)

    arrays = {"ps_weights": canon(fm.ps_weights)}
    for name in ("velocities", "errors", "weights"):
        arr = getattr(fm.client_states, name)
        if arr is not None:
            arrays["client/" + name] = _host(arr)
    arrays.update({"model_state/" + k: _host(v)
                   for k, v in fm._model_state.items()})
    st = optimizer.server_state
    group = getattr(fm, "group", None)
    sharded = group is not None and fm.round_config.server_shard
    if sharded:
        from commefficient_torch.ops.collectives import all_gather_tiled

        def gather(t):
            return all_gather_tiled(t, group)

        dense = fm.server_config.mode != "sketch"
        for name, t in (("velocity", st.velocity), ("error", st.error)):
            arrays["server/" + name] = _host(
                gather(t)[:fm.grad_size] if dense else t)
        if st.qres is not None:
            arrays["server/qres"] = _host(gather(st.qres[None]))
        if st.dres is not None:
            arrays["server/dres"] = _host(gather(st.dres))
    else:
        arrays["server/velocity"] = _host(st.velocity)
        arrays["server/error"] = _host(st.error)
    arrays["torch_rng/state"] = fm._rng.get_state().numpy()
    np_name, np_keys, np_pos, np_has_gauss, np_cached = \
        np.random.get_state()
    arrays["np_rng/keys"] = np_keys
    _, d_keys, d_pos, d_gauss, d_cached = fm._drop_rng.get_state()
    arrays["drop_rng/keys"] = d_keys
    arrays["drop_rng/meta"] = np.asarray([d_pos, d_gauss], np.int64)
    arrays["drop_rng/cached"] = np.asarray([d_cached], np.float64)
    part = getattr(fm, "_participation", None)
    meta_participation = None
    if part is not None:
        if sharded:
            from commefficient_torch.ops.collectives import all_gather_tiled

            # the ranks' partial sums, stacked (n, ...) as JAX saves them
            def held(t):
                return _host(all_gather_tiled(t[None].contiguous(), group))
        else:
            held = _host
        p_arrays, meta_participation = part.state_payload(held)
        arrays.update({"part/" + k: v for k, v in p_arrays.items()})
    # the churn layer's masks and RNG; a run without churn writes no pop/*
    pop = getattr(fm, "_population", None)
    meta_population = None
    if pop is not None:
        pop_arrays, meta_population = pop.state_payload()
        arrays.update({"pop/" + k: v for k, v in pop_arrays.items()})
    if fm._simple_download:
        arrays["acct/updated_since_init"] = canon(fm._updated_since_init)
    else:
        arrays["acct/last_changed"] = canon(fm._last_changed)
        arrays["acct/client_part_round"] = np.asarray(fm._client_part_round)
    # the accounting marks round k's changed coordinates at round k+1's
    # dispatch (against _prev_ps), so _prev_ps lags the weights by one
    # round at any save point: without it the resumed run would never
    # charge the last round before the save
    arrays["acct/prev_ps"] = canon(fm._prev_ps)
    meta = {
        "next_epoch": int(next_epoch),
        "lr_step_count": int(lr_scheduler._step_count),
        "total_download": float(totals[0]),
        "total_upload": float(totals[1]),
        "np_rng": {"name": np_name, "pos": int(np_pos),
                   "has_gauss": int(np_has_gauss),
                   "cached": float(np_cached)},
        "round_idx": int(getattr(fm, "_round_idx", 0)),
        "rounds_dispatched": int(fm.rounds_dispatched),
    }
    if meta_participation is not None:
        meta["participation"] = meta_participation
    if meta_population is not None:
        meta["population"] = meta_population
    if mid_epoch is not None:
        sampler = mid_epoch.get("sampler")
        assert sampler is not None, (
            "mid-epoch save needs the FedSampler position "
            "(FedSampler.get_state())")
        arrays["sampler/permuted"] = np.asarray(sampler["permuted"],
                                                np.int64)
        arrays["sampler/cursor"] = np.asarray(sampler["cursor"], np.int64)
        # the participation layer's bookkeeping (absent in older states)
        if "retry" in sampler:
            arrays["sampler/retry"] = np.asarray(sampler["retry"], np.int64)
        if "quarantined" in sampler:
            arrays["sampler/quarantined"] = np.asarray(
                sampler["quarantined"], bool)
        extras = mid_epoch.get("extras") or {}
        for name, val in extras.items():
            arrays["mid/" + name] = np.asarray(val)
        meta["mid_epoch"] = {"rounds_done": int(mid_epoch["rounds_done"]),
                             "extras": sorted(extras)}
    if not path.endswith(".npz"):
        path = path + ".npz"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    store = getattr(fm, "_row_store", None)
    if store is not None:
        _save_row_snapshot(path, store, arrays, meta,
                           getattr(fm, "is_main", True))
    meta["checksum"] = _content_checksum(arrays)
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(),
                                        dtype=np.uint8)
    # atomic: a crash mid-save must not leave a truncated file at the
    # expected name; the tmp name keeps the .npz suffix so np.savez does
    # not append another one
    tmp = path[:-len(".npz")] + ".tmp.npz"
    if getattr(fm, "is_main", True):
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    if group is not None:
        # no rank reads the file before rank 0 has written it
        torch.distributed.barrier(group=group.group)
    return path


def _save_row_snapshot(path: str, store, arrays, meta: dict,
                       write: bool) -> None:
    """The disk tier's part of a run state (module docstring). ``write``
    is rank 0's: the other ranks hold the same rows and only drain."""
    stem = path[:-len(".npz")]
    if store.directory is not None:
        # the save is the drain barrier the row lifecycle needs: retired
        # rows zero and become holes, and a compaction (at the hole
        # threshold) packs the files, so this snapshot records the packed
        # layout and its directory together. Every rank keeps its store
        # in step.
        store.flush_retired()
        store.maybe_compact()
    if write:
        tmp_rows = stem + ".tmp.rows"
        if os.path.isdir(tmp_rows):
            shutil.rmtree(tmp_rows)
        store_meta = store.save_snapshot(tmp_rows)
        if os.path.isdir(stem + ".rows"):
            shutil.rmtree(stem + ".rows")
        os.replace(tmp_rows, stem + ".rows")
        # the snapshot is the store's repair source: re-point it at the
        # renamed directory
        store.snapshot_moved(stem + ".rows")
    else:
        store.drain()
        store_meta = {"backend": store.backend, "rows": store.num_rows,
                      "members": {}}
    store_meta["dir"] = os.path.basename(stem) + ".rows"
    meta["client_store"] = store_meta
    if store.inject is not None:
        _, io_keys, io_pos, io_gauss, io_cached = \
            store.inject.rng.get_state()
        arrays["io/rng_keys"] = io_keys
        arrays["io/rng_meta"] = np.asarray([io_pos, io_gauss], np.int64)
        arrays["io/rng_cached"] = np.asarray([io_cached], np.float64)
        meta["io_fault"] = {"spec": store.inject.schedule.spec(),
                            "injected": dict(store.inject.injected)}
    if store._row_fails:
        arrays["io/row_fails"] = np.asarray(
            sorted(store._row_fails.items()), np.int64).reshape(-1, 2)


def maybe_save_run_state(args, epoch: int, fed_model, optimizer,
                         lr_scheduler, totals) -> None:
    """The per-epoch ``--checkpoint_every`` hook."""
    if args.checkpoint_every and (epoch + 1) % args.checkpoint_every == 0:
        path = save_run_state(
            os.path.join(args.checkpoint_path, f"run_state_ep{epoch + 1}"),
            fed_model, optimizer, lr_scheduler, next_epoch=epoch + 1,
            totals=totals)
        print(f"run state saved to {path} (epoch {epoch + 1})")
        if getattr(fed_model, "is_main", True):
            prune_run_states(args.checkpoint_path,
                             getattr(args, "keep_checkpoints", 0))


def save_round_state(args, epoch: int, rounds_done: int, sampler_state,
                     fed_model, optimizer, lr_scheduler, totals,
                     extras=None) -> str:
    """The mid-epoch ``--checkpoint_every_rounds`` hook. ``epoch`` is the
    0-based epoch in progress; the file is ``run_state_ep{epoch+1}_r{
    rounds_done}`` and a resume re-enters that epoch at that round."""
    path = save_run_state(
        os.path.join(args.checkpoint_path,
                     f"run_state_ep{epoch + 1}_r{rounds_done}"),
        fed_model, optimizer, lr_scheduler, next_epoch=epoch,
        totals=totals,
        mid_epoch={"rounds_done": rounds_done, "sampler": sampler_state,
                   "extras": extras or {}})
    print(f"run state saved to {path} "
          f"(epoch {epoch + 1}, round {rounds_done})")
    if getattr(fed_model, "is_main", True):
        prune_run_states(args.checkpoint_path,
                         getattr(args, "keep_checkpoints", 0))
    return path


_RUN_STATE_RE = re.compile(r"run_state_ep(\d+)(?:_r(\d+))?\.npz$")


def _run_state_progress(path: str):
    """Training progress in a run-state file name, as an ordering key:
    ``run_state_ep{N}`` (N epochs completed) -> ``(N, 0)``;
    ``run_state_ep{N}_r{R}`` (epoch N in progress, R rounds done) ->
    ``(N-1, R)``. None for names this module did not write."""
    m = _RUN_STATE_RE.search(os.path.basename(path))
    if m is None:
        return None
    epoch = int(m.group(1))
    return (epoch, 0) if m.group(2) is None else (epoch - 1, int(m.group(2)))


def _run_state_files(checkpoint_path: str):
    """``run_state*.npz`` candidates, newest first by the progress in the
    name (mtime breaks ties only among other names); ``.tmp.npz`` write
    intermediates are never candidates."""
    try:
        names = os.listdir(checkpoint_path)
    except OSError:
        return []
    cands = [os.path.join(checkpoint_path, n) for n in names
             if n.startswith("run_state") and n.endswith(".npz")
             and ".tmp." not in n]

    def key(path):
        progress = _run_state_progress(path)
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            mtime = float("-inf")  # vanished since listdir: rank last
        return ((1,) + progress if progress is not None else (0,),
                mtime, path)

    return sorted(cands, key=key, reverse=True)


def pinned_run_states(checkpoint_path: str) -> set:
    """The run states a reader pins (absolute paths): each ``*.pin`` file
    in the directory is a JSON lease ``{"paths": [...], "owner": ...}``,
    written atomically by a serving replica and removed when it releases.
    An unreadable lease pins nothing and is reported."""
    pinned = set()
    try:
        names = os.listdir(checkpoint_path)
    except OSError:
        return pinned
    for n in names:
        if not n.endswith(".pin"):
            continue
        fn = os.path.join(checkpoint_path, n)
        try:
            with open(fn) as f:
                lease = json.load(f)
            for p in lease.get("paths", []):
                if not os.path.isabs(p):
                    p = os.path.join(checkpoint_path, p)
                pinned.add(os.path.abspath(p))
        except (OSError, ValueError) as e:
            print(f"ignoring unreadable pin file {fn}: {e}")
    return pinned


def prune_run_states(checkpoint_path: str, keep: int) -> None:
    """``--keep_checkpoints N``: drop all but the newest N run-state files
    (``keep`` <= 0 keeps everything, the default). A run state that a
    ``*.pin`` lease names is never deleted and does not count against
    ``keep``."""
    if not keep or keep <= 0:
        return
    pinned = pinned_run_states(checkpoint_path)
    for path in _run_state_files(checkpoint_path)[keep:]:
        if os.path.abspath(path) in pinned:
            print(f"keeping pinned run state {path} (serving lease)")
            continue
        try:
            os.remove(path)
            # a disk-tier run state's row snapshot lives beside it
            rows = path[:-len(".npz")] + ".rows"
            if os.path.isdir(rows):
                shutil.rmtree(rows)
            print(f"pruned old run state {path} (--keep_checkpoints {keep})")
        except OSError as e:
            print(f"could not prune {path}: {e}")


def _verify_row_snapshot(path: str, meta: dict) -> None:
    """A disk-tier run state's ``.rows`` snapshot against the CRCs in its
    meta (part of ``--resume auto``: the ``.rows`` directory lands before
    the ``.npz`` and names repeat across resumes, so a crash between the
    two renames can pair an older archive with newer rows)."""
    store = meta.get("client_store")
    if store is None:
        return
    from commefficient_torch.federated.host_state import (
        _file_crc,
        _row_extents,
        _snapshot_rows,
    )

    snap_dir = os.path.join(os.path.dirname(path) or ".", store["dir"])
    for name, m in store["members"].items():
        fn = os.path.join(snap_dir, f"{name}.f32")
        if not os.path.exists(fn):
            raise RuntimeError(f"row-store snapshot missing {fn}")
        # read only the rows the snapshot's CRC sidecar records as written
        nb = int(np.prod(m["shape"])) * 4
        crc = _file_crc(fn, _row_extents(_snapshot_rows(snap_dir, name, nb),
                                         nb, int(store["rows"]) * nb))
        if crc != int(m["crc"]):
            raise RuntimeError(
                f"row-store snapshot corrupt ({fn}): content CRC "
                f"{crc:#010x} != recorded {int(m['crc']):#010x}")


def find_resume_checkpoint(checkpoint_path: str,
                           return_contents: bool = False, exclude=()):
    """``--resume auto``: the newest run state under ``checkpoint_path``
    that reads and checksums clean, its ``.rows`` snapshot included;
    corrupt or truncated candidates are reported and skipped. None when
    nothing valid exists. ``exclude`` and the ``os.pathsep``-joined
    ``COMMEFFICIENT_RESUME_EXCLUDE`` name candidates to skip whatever
    their validity: the supervisor's poison-checkpoint seam
    (``commefficient_torch/scripts/supervise.py``).
    ``return_contents=True`` returns ``(path, (flat, meta))`` for
    ``load_run_state(preloaded=...)``, so the file is read once."""
    excluded = {os.path.abspath(p) for p in exclude}
    env = os.environ.get("COMMEFFICIENT_RESUME_EXCLUDE", "")
    excluded |= {os.path.abspath(p) for p in env.split(os.pathsep) if p}
    for path in _run_state_files(checkpoint_path):
        if os.path.abspath(path) in excluded:
            print(f"--resume auto: skipping {path}: excluded "
                  f"(poison-checkpoint list)")
            continue
        try:
            flat = _read_npz(path)
            meta = json.loads(bytes(flat.pop("meta_json")).decode())
            _verify_checksum(flat, meta, path)
        except Exception as e:  # corrupt candidate: fall back to older
            print(f"--resume auto: skipping {path}: corrupt npz ({e})")
            continue
        try:
            _verify_row_snapshot(path, meta)
        except Exception as e:
            print(f"--resume auto: skipping {path}: bad .rows snapshot "
                  f"({e})")
            continue
        return (path, (flat, meta)) if return_contents else path
    return None


def _reject_unported(flat: Dict[str, np.ndarray], meta: dict) -> None:
    for prefix, item in _UNPORTED_PLANES:
        keys = sorted(k for k in flat if k.startswith(prefix))
        if keys:
            raise NotImplementedError(
                f"the run state carries {keys[0]!r}, a plane the port does "
                f"not have yet ({item})")


def load_run_state(path: str, fed_model, optimizer, lr_scheduler,
                   preloaded=None):
    """Restore a run state in place (the port's or the JAX package's);
    returns ``(next_epoch, (total_download, total_upload), mid)``, where
    ``mid`` is None at an epoch boundary, else ``{"rounds_done": int,
    "sampler": FedSampler state, "extras": {...}}``. Corrupt files and
    checksum mismatches raise one ``RuntimeError``; a geometry mismatch
    (another model, sketch or ``--mode``) raises before anything is
    restored."""
    from commefficient_torch.federated.rounds import ClientStates
    from commefficient_torch.federated.server import ServerState

    fm = fed_model
    if not path.endswith(".npz"):
        path = path + ".npz"
    if preloaded is not None:
        flat, meta = preloaded
        flat = dict(flat)  # the restore pops keys; keep the caller's
    else:
        flat = _read_npz(path)
        meta = json.loads(bytes(flat.pop("meta_json")).decode())
        _verify_checksum(flat, meta, path)
    _reject_unported(flat, meta)
    mid = None
    if meta.get("mid_epoch") is not None:
        sampler_state = {"permuted": flat.pop("sampler/permuted"),
                         "cursor": flat.pop("sampler/cursor")}
        for key in ("retry", "quarantined"):
            if "sampler/" + key in flat:
                sampler_state[key] = flat.pop("sampler/" + key)
        mid = {
            "rounds_done": int(meta["mid_epoch"]["rounds_done"]),
            "sampler": sampler_state,
            "extras": {name: flat.pop("mid/" + name)
                       for name in meta["mid_epoch"]["extras"]},
        }

    def check_shape(what, got, want):
        assert tuple(got) == tuple(want), (
            f"checkpoint geometry mismatch: {what} has shape {tuple(got)} "
            f"but this run expects {tuple(want)} — was the checkpoint "
            f"written with a different model/sketch geometry or --mode?")

    layout = fm.layout
    dev = fm.device
    check_shape("ps_weights", flat["ps_weights"].shape, (fm.grad_size,))
    cur = optimizer.server_state
    group = getattr(fm, "group", None)
    dense_sharded = (group is not None and fm.round_config.server_shard
                     and fm.server_config.mode != "sketch")
    server_shape = (fm.grad_size,) if dense_sharded else cur.velocity.shape
    check_shape("server velocity", flat["server/velocity"].shape,
                server_shape)
    check_shape("server error", flat["server/error"].shape, server_shape)
    store = getattr(fm, "_row_store", None)
    store_meta = meta.get("client_store")
    rows_dir = (os.path.join(os.path.dirname(path) or ".", store_meta["dir"])
                if store_meta is not None else None)
    cs = None
    if store is None:
        if store_meta is not None:
            # a disk-tier run state into the hbm or host tier: lift each
            # snapshot member to a full array (RAM must hold it)
            from commefficient_torch.federated.host_state import (
                read_snapshot_member,
            )

            for name in store_meta["members"]:
                flat["client/" + name] = read_snapshot_member(
                    rows_dir, store_meta, name)
        cs = {}
        for name in ("velocities", "errors", "weights"):
            key = "client/" + name
            have = getattr(fm.client_states, name)
            if key in flat:
                assert have is not None, (
                    f"checkpoint has client {name} but this config "
                    f"allocates none")
                check_shape(f"client {name}", flat[key].shape, have.shape)
                cs[name] = torch.from_numpy(flat[key].copy()).to(
                    have.device)
            else:
                assert have is None, (
                    f"config allocates client {name} but checkpoint has "
                    f"none")
                cs[name] = None
    else:
        for name in ("velocities", "errors", "weights"):
            key = "client/" + name
            if name in store.row_shapes:
                if store_meta is None:
                    assert key in flat, (
                        f"config allocates client {name} but checkpoint "
                        f"has none")
                    check_shape(f"client {name}", flat[key].shape,
                                (store.num_rows,) + store.row_shapes[name])
            else:
                assert key not in flat and (
                    store_meta is None
                    or name not in store_meta["members"]), (
                    f"checkpoint has client {name} but this config "
                    f"allocates none")
    mstate = {k[len("model_state/"):]: v for k, v in flat.items()
              if k.startswith("model_state/")}
    assert sorted(mstate) == sorted(fm._model_state), (
        f"checkpoint geometry mismatch: model state {sorted(mstate)} but "
        f"this run has {sorted(fm._model_state)} — was the checkpoint "
        f"written with a different model or --batchnorm?")
    for k, v in mstate.items():
        check_shape(f"model state {k}", v.shape, fm._model_state[k].shape)
    if "torch_rng/state" not in flat:
        # a JAX package's run state: its rng key drives JAX's noise
        # stream, which the port's generator cannot continue
        if fm.args.do_dp:
            raise ValueError(
                "this run state was written by the JAX package, whose DP "
                "noise stream the port's generator cannot continue; "
                "resume a --dp run from a run state the port wrote")

    def resident(arr, tail_fill=None):
        # the file holds the flat (d,) view; a chunked run re-chunks, with
        # tail_fill where the tail is not zero (last_changed keeps -1, so
        # a tail position is never charged)
        t = torch.from_numpy(np.array(arr)).to(dev)
        if layout is None:
            return t
        c = layout.chunk(t)
        if tail_fill is not None:
            c = torch.where(layout.flat_index(dev) < layout.d, c,
                            torch.full((), tail_fill, dtype=c.dtype,
                                       device=dev))
        return c

    fm.ps_weights = resident(flat["ps_weights"])
    prefetcher = getattr(fm, "_prefetcher", None)
    if prefetcher is not None:
        # a prefetched cohort was read from the rows before the restore
        prefetcher.invalidate()
    if store is not None:
        if store_meta is not None:
            store.restore_snapshot(rows_dir, store_meta)
        else:
            for name in store.row_shapes:
                store.write_full(name, flat.pop("client/" + name))
        _restore_io(store, flat, meta)
    else:
        fm.client_states = ClientStates(**cs)
        stream = getattr(fm, "_row_stream", None)
        if stream is not None:
            stream.load(fm.client_states)
            fm.client_states = stream.states
    fm._model_state = {k: torch.from_numpy(v.copy()).to(dev, torch.float32)
                       for k, v in sorted(mstate.items())}
    if "torch_rng/state" in flat:
        fm._rng.set_state(torch.from_numpy(flat["torch_rng/state"].copy()))
    def server_resident(arr):
        # the file holds the full (d,) view; a sharded dense run takes its
        # slice of the d_pad-padded vector
        t = torch.from_numpy(np.array(arr)).to(dev)
        if dense_sharded:
            per = cur.velocity.shape[0]
            t = torch.nn.functional.pad(t, (0, per * group.size - t.shape[0]))
            t = t[group.rank * per:(group.rank + 1) * per].clone()
        return t

    def restore_carry(name, have, what):
        """This rank's slice of a quantized collective's carry when the
        file holds one at this geometry, else zeros (with a warning)."""
        import warnings

        if have is None:
            return None
        key = "server/" + name
        n = group.size
        arr = flat.get(key)
        if name == "qres":
            want = (n,) + tuple(have.shape)
        else:
            want = (n * have.shape[0],) + tuple(have.shape[1:])
        if arr is not None and tuple(arr.shape) == want:
            a = arr[group.rank] if name == "qres" else \
                arr[group.rank * have.shape[0]:
                    (group.rank + 1) * have.shape[0]]
            return torch.from_numpy(np.array(a)).to(dev)
        warnings.warn(f"checkpoint has no matching {key} carry; "
                      f"re-initializing the {what} residual to zero")
        return torch.zeros_like(have)

    optimizer.server_state = ServerState(
        velocity=server_resident(flat["server/velocity"]),
        error=server_resident(flat["server/error"]),
        qres=restore_carry("qres", cur.qres, "quantized-reduce"),
        dres=restore_carry("dres", cur.dres, "quantized-downlink"))
    np_meta = meta["np_rng"]
    np.random.set_state((np_meta["name"], flat["np_rng/keys"],
                         np_meta["pos"], np_meta["has_gauss"],
                         np_meta["cached"]))
    if "drop_rng/keys" in flat:
        d_pos, d_gauss = (int(x) for x in flat["drop_rng/meta"])
        fm._drop_rng.set_state(("MT19937", flat["drop_rng/keys"], d_pos,
                                d_gauss, float(flat["drop_rng/cached"][0])))
    _restore_participation(fm, flat, meta, group)
    _restore_population(fm, flat, meta)
    if fm._simple_download:
        fm._updated_since_init = resident(flat["acct/updated_since_init"])
    else:
        fm._last_changed = resident(flat["acct/last_changed"], tail_fill=-1)
        fm._client_part_round = np.asarray(
            flat["acct/client_part_round"]).astype(np.int64)
        fm._round_idx = int(meta["round_idx"])
        fm._round_idx_dev = torch.full((), fm._round_idx, dtype=torch.int32,
                                       device=dev)
    fm._prev_ps = (resident(flat["acct/prev_ps"]) if "acct/prev_ps" in flat
                   else fm.ps_weights)
    fm._rounds_dispatched = int(meta.get("rounds_dispatched", 0))
    lr_scheduler._step_count = int(meta["lr_step_count"])
    lr_scheduler.optimizer.set_lr_factor(
        lr_scheduler.lr_lambda(meta["lr_step_count"]))
    return (meta["next_epoch"],
            (meta["total_download"], meta["total_upload"]), mid)


def _restore_io(store, flat, meta) -> None:
    """The storage-fault injector's RNG and counts and the per-row failure
    counts (``io/*``, meta ``io_fault``); a run state without them
    restarts the schedule from its seed, one with them into a run without
    a schedule warns and ignores them, as in the JAX package."""
    import warnings

    io_flat = {k: flat.pop(k) for k in list(flat) if k.startswith("io/")}
    if meta.get("io_fault") is not None:
        if store.inject is not None:
            store.inject.rng.set_state(
                ("MT19937", io_flat["io/rng_keys"],
                 int(io_flat["io/rng_meta"][0]),
                 int(io_flat["io/rng_meta"][1]),
                 float(io_flat["io/rng_cached"][0])))
            store.inject.injected.update(
                {k: int(v) for k, v in
                 meta["io_fault"].get("injected", {}).items()})
        else:
            warnings.warn(
                "checkpoint carries --inject_io_fault state but this run "
                "has no injection schedule; ignoring it")
    if "io/row_fails" in io_flat:
        store._row_fails = {int(r): int(c)
                            for r, c in io_flat["io/row_fails"]}


def _restore_population(fm, flat, meta) -> None:
    """The churn layer's ``pop/*`` and meta ``population``; the row
    directory has restored with the ``.rows`` snapshot, and the manager
    checks the two agree. A mismatch between the file and the run warns,
    as in the JAX package (on the disk tier the snapshot's restore has
    already refused a missing or unexpected directory)."""
    import warnings

    pop = getattr(fm, "_population", None)
    pop_flat = {k[len("pop/"):]: flat.pop(k) for k in list(flat)
                if k.startswith("pop/")}
    if meta.get("population") is not None:
        if pop is not None:
            pop.restore_state(pop_flat, meta["population"])
        else:
            warnings.warn(
                "checkpoint carries population-churn state but this run "
                "has no --churn; the closed-population run ignores it")
    elif pop is not None:
        warnings.warn(
            "this run churns the population but the checkpoint predates "
            "the churn layer; the churn schedule restarts from its seed")


def _restore_participation(fm, flat, meta, group) -> None:
    """The participation layer's ``part/*`` and meta (a mismatch between
    the file and the run warns, as in the JAX package). Under
    ``--server_shard`` a held sum is saved as the ``(n, ...)`` stack of
    the ranks' partial sums, and each rank takes its own back."""
    import warnings

    part = getattr(fm, "_participation", None)
    part_flat = {k[len("part/"):]: flat.pop(k) for k in list(flat)
                 if k.startswith("part/")}
    if meta.get("participation") is None:
        if part is not None and part.schedule is not None:
            warnings.warn(
                "this run injects client faults but the checkpoint predates "
                "the participation layer; the fault schedule restarts from "
                "its seed")
        return
    if part is None:
        warnings.warn(
            "checkpoint carries participation/fault-injection state but "
            "this run has no participation layer attached; ignoring it")
        return
    sharded = group is not None and fm.round_config.server_shard
    want = (tuple(fm.sketch.table_shape) if fm.sketch is not None
            else tuple(fm.ps_weights.shape))

    def as_device(a):
        a = np.asarray(a)
        if sharded and a.shape == (group.size,) + want:
            a = a[group.rank]
        assert tuple(a.shape) == want, (
            f"checkpoint geometry mismatch: a held transmit sum has shape "
            f"{tuple(a.shape)} but this run's transmit is {want} (a run "
            f"state's held sums restore on the plane and group size that "
            f"saved them)")
        return torch.from_numpy(np.array(a, np.float32)).to(fm.device)

    part.restore_state(part_flat, meta["participation"], as_device)


def restore_mid_epoch(resume_mid, loader, client_download, client_upload):
    """The training loop's mid-epoch re-entry: arm the sampler at the
    saved position and fold the partial per-client byte accumulators in
    place. Returns ``(rounds_done, extras)``; ``(0, {})`` when not
    resuming mid-epoch."""
    if resume_mid is None:
        return 0, {}
    loader.sampler.set_state(resume_mid["sampler"])
    extras = resume_mid.get("extras", {})
    if "download" in extras:
        client_download += extras["download"]
    if "upload" in extras:
        client_upload += extras["upload"]
    return int(resume_mid["rounds_done"]), extras


def resume_run(args, fed_model, optimizer, lr_scheduler):
    """The ``--resume`` hook: resolve the path ('auto' = the newest run
    state that reads and checksums clean), restore in place, report.
    Returns ``(start_epoch, totals, mid)``; ``(0, (0.0, 0.0), None)`` when
    not resuming."""
    path, blob = args.resume or None, None
    if path == "auto":
        found = find_resume_checkpoint(args.checkpoint_path,
                                       return_contents=True)
        if found is None:
            print(f"--resume auto: no valid run-state checkpoint under "
                  f"{args.checkpoint_path}; starting fresh")
            path = None
        else:
            path, blob = found
    if not path:
        return 0, (0.0, 0.0), None
    start_epoch, totals, mid = load_run_state(path, fed_model, optimizer,
                                              lr_scheduler, preloaded=blob)
    at = f"epoch {start_epoch + 1}"
    if mid is not None:
        at += f", round {mid['rounds_done']}"
    print(f"resumed run state from {path} (continuing at {at})")
    return start_epoch, totals, mid
