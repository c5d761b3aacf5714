"""Rank bodies of the port's multi-process tests, and the harness that
spawns them: ``gloo`` process groups on the CPU, one process a rank.

This module imports neither JAX nor the JAX package, so a child starts
fast; the tests compute the JAX side in the parent and pass numpy arrays
in and out. ``start_ranks`` starts the children from a ``spawn`` context
and ``Ranks.join`` joins them with a timeout (killing them and failing
on it); the parent can compute its side in between. One spawn runs
several bodies in turn, each on a process group of its own that meets at
a ``FileStore`` under the test's temporary directory (never a fixed TCP
port: several test workers run at once). Each child runs with one
thread.
"""

from __future__ import annotations

import os
import pickle
import time
import traceback

import numpy as np

TIMEOUT = 110  # seconds for all the ranks of one spawn


def _entry(rank: int, items, tmp: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    out_path = os.path.join(tmp, f"rank{rank}.pkl")
    outs = []
    try:
        for i, (body, payload, k) in enumerate(items):
            if rank >= k:  # this body runs on the first k ranks
                outs.append(None)
                continue
            init = f"file://{tmp}/store{i}"
            if body.startswith("cli_"):
                # an entry point under torchrun's environment: it starts
                # and ends the process group itself; "local_world" places
                # the k ranks node-major on k / local_world nodes
                env = dict(os.environ)
                lw = int(payload.get("local_world", k))
                os.environ.update(RANK=str(rank), WORLD_SIZE=str(k),
                                  LOCAL_RANK=str(rank % lw),
                                  LOCAL_WORLD_SIZE=str(lw))
                outs.append(globals()[body](init, payload))
                os.environ.clear()
                os.environ.update(env)
            else:
                dist.init_process_group("gloo", init_method=init,
                                        rank=rank, world_size=k)
                from commefficient_torch.parallel import ClientGroup

                cg = ClientGroup(None, rank, k, torch.device("cpu"))
                outs.append(globals()[body](cg, payload))
                dist.destroy_process_group()
        with open(out_path, "wb") as f:
            pickle.dump(("ok", outs), f)
    except BaseException:  # noqa: BLE001 -- reported to the parent
        with open(out_path, "wb") as f:
            pickle.dump(("error", traceback.format_exc()), f)
        raise


class Ranks:
    """The children of one ``start_ranks`` call. As a context manager it
    kills any child still running when its block ends (a parent that
    failed before ``join``)."""

    def __init__(self, n, items, tmp_path, timeout):
        import multiprocessing as mp

        self.n, self.items, self.timeout = n, items, timeout
        self.tmp = os.path.join(str(tmp_path),
                                f"ranks_{n}_{time.time_ns()}")
        os.makedirs(self.tmp)
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_entry, args=(r, items, self.tmp))
                      for r in range(n)]
        for p in self.procs:
            p.start()
        self.deadline = time.time() + timeout

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()

    def join(self):
        """Each item's results in rank order (its first k ranks). A
        child's exception, a nonzero exit or the timeout raises
        ``RuntimeError``."""
        for p in self.procs:
            p.join(max(0.0, self.deadline - time.time()))
        hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()
        per_rank, errors = [], []
        for r, p in enumerate(self.procs):
            path = os.path.join(self.tmp, f"rank{r}.pkl")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    status, val = pickle.load(f)
                if status != "ok":
                    errors.append(f"rank {r}:\n{val}")
                per_rank.append(val)
            else:
                errors.append(f"rank {r}: no result (exit {p.exitcode})")
        names = [body for body, _, _ in self.items]
        if hung:
            raise RuntimeError(f"{names}: ranks {hung} timed out after "
                               f"{self.timeout} s\n" + "\n".join(errors))
        if errors:
            raise RuntimeError(f"{names} failed\n" + "\n".join(errors))
        return [[per_rank[r][i] for r in range(k)]
                for i, (_, _, k) in enumerate(self.items)]


def start_ranks(n: int, items, tmp_path, timeout=TIMEOUT) -> Ranks:
    """Start ``n`` gloo ranks that run ``items`` in turn: each a ``(body,
    payload)`` on all n ranks or a ``(body, payload, k)`` on the first k,
    as ``body(group, payload)`` (a ``cli_`` body: ``body(init_method,
    payload)``)."""
    items = [(it[0], it[1], it[2] if len(it) > 2 else n) for it in items]
    assert all(1 <= k <= n for _, _, k in items), items
    return Ranks(n, items, tmp_path, timeout)


def _t(a):
    import torch

    return torch.from_numpy(np.array(a))


def _np(t):
    return None if t is None else t.detach().cpu().numpy().copy()


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------

def body_collectives(cg, cases):
    """Each case: ``op`` and this rank's ``x`` (and ``u``, ``residual``,
    ``block``, ``dtype``) from per-rank stacks."""
    from commefficient_torch.ops import collectives as C

    r = cg.rank
    out = []
    for case in cases:
        x = _t(case["x"][r])
        op = case["op"]
        if op == "reduce_scatter":
            out.append({"tile": _np(C.reduce_scatter_sum(x, cg)),
                        "sum": _np(C.all_reduce_sum(x.clone(), cg))})
        elif op == "all_gather":
            out.append({"full": _np(C.all_gather_tiled(x, cg))})
        else:
            fn = {"qscatter": C.quantized_psum_scatter,
                  "qpsum": C.quantized_psum,
                  "qgather": C.quantized_all_gather}[op]
            res = case.get("residual")
            got, new_res = fn(
                x, cg, residual=None if res is None else _t(res[r]),
                block=case["block"], dtype=case["dtype"],
                u=_t(case["u"][r]))
            out.append({"out": _np(got), "res": _np(new_res)})
    return out


# --------------------------------------------------------------------------
# the sharded server step
# --------------------------------------------------------------------------

def body_server(cg, cases):
    """Each case: this rank's transmit into ``sharded_server_update``, and
    the replicated step on the all-reduced transmit; this rank's slices
    and the full outputs."""
    import torch

    from commefficient_torch.federated import server as S
    from commefficient_torch.ops.collectives import (
        all_reduce_sum,
        parse_collective_plan,
        sr_generator,
    )
    from commefficient_torch.ops.sketch import make_sketch

    r, n = cg.rank, cg.size
    out = []
    for c in cases:
        cfg = S.ServerConfig(mode=c["mode"], error_type=c["error_type"],
                             k=c["k"], grad_size=c["d"],
                             virtual_momentum=c["vm"],
                             fused_epilogue=c.get("fused", False))
        sk = layout = None
        if c["mode"] == "sketch":
            sk = make_sketch(c["d"], c["c"], c["r"], seed=c["seed"],
                             num_blocks=1, device="cpu")
            layout = sk.chunk_layout
        plan = parse_collective_plan(c.get("plan", ""))
        vel0, err0 = _t(c["vel0"]), _t(c["err0"])
        base = S.init_server_state(cfg, sk, device="cpu", shard_n=n,
                                   plan=plan)
        if c["mode"] == "sketch":
            st = base._replace(velocity=vel0.clone(), error=err0.clone())
        else:
            per = base.velocity.shape[0]
            pad = per * n - c["d"]
            sl = slice(r * per, (r + 1) * per)
            st = base._replace(
                velocity=torch.nn.functional.pad(vel0, (0, pad))[sl],
                error=torch.nn.functional.pad(err0, (0, pad))[sl])
        tr = _t(c["transmits"][r])
        lr = c["lr"]
        count = torch.tensor(c["count"], dtype=torch.float32)
        rounds = []
        for rnd in range(c.get("rounds", 1)):
            sr = {leg: sr_generator(0, rnd, r, leg, "cpu")
                  for leg in ("up", "down")}
            old = st
            upd, st, rs = S.sharded_server_update(
                tr, st, cfg, lr, count, cg, sketch=sk, layout=layout,
                plan=plan, sr=sr)
            rounds.append({"update": _np(upd), "vel": _np(st.velocity),
                           "err": _np(st.error), "resketched": _np(rs),
                           "qres": _np(st.qres), "dres": _np(st.dres),
                           "old_qres": _np(old.qres),
                           "old_dres": _np(old.dres)})
        reduced = all_reduce_sum(tr.clone(), cg)
        rep_upd, rep_st = S.server_update(
            reduced / count, S.ServerState(vel0.clone(), err0.clone()), cfg,
            lr, sketch=sk, layout=layout)
        out.append({"rounds": rounds, "reduced": _np(reduced),
                    "rep_update": _np(rep_upd),
                    "rep_vel": _np(rep_st.velocity),
                    "rep_err": _np(rep_st.error)})
    return out


# --------------------------------------------------------------------------
# rounds through FedModel / FedOptimizer
# --------------------------------------------------------------------------

TINY = (("prep", 8), ("layer1", 16), ("layer2", 16), ("layer3", 32))


def _resnet9_model(spec, group, argv=None, init=True):
    from commefficient_torch.config import parse_args
    from commefficient_torch.convert import flat_from_jax
    from commefficient_torch.federated import FedModel, FedOptimizer
    from commefficient_torch.federated.losses import make_cv_losses
    from commefficient_torch.models import ResNet9
    from commefficient_torch.ops.flat import ParamLayout

    args = parse_args(argv=list(argv if argv is not None else spec["argv"])
                      + ["--device", "cpu"])
    m = ResNet9(channels=TINY, do_batchnorm=args.do_batchnorm)
    train, val = make_cv_losses(m)
    fm = FedModel(m, train, args, val, num_clients=spec["num_clients"],
                  init_params=flat_from_jax(spec["flat0"], ParamLayout(m))
                  if init else None, device="cpu", group=group)
    opt = FedOptimizer(fm, args)
    opt.set_lr_factor(spec["lr"])
    return fm, opt


def _weights(fm):
    w = fm.layout.unchunk(fm.ps_weights) if fm.layout is not None \
        else fm.ps_weights
    return _np(w)


def body_rounds(cg, spec):
    """``spec["runs"]``: argv lists; each runs ``spec["batches"]`` through
    a fresh model on this group. Per run and round: the fetched results
    and the weights; at the end the server and client state."""
    out = []
    for argv in spec["runs"]:
        fm, opt = _resnet9_model(spec, cg, argv)
        rounds = []
        for b in spec["batches"]:
            res = fm(b)
            opt.step()
            rounds.append({"res": res, "w": _weights(fm),
                           "ms": {k: _np(v)
                                  for k, v in fm._model_state.items()}})
        st = opt.server_state
        out.append({"rounds": rounds, "vel": _np(st.velocity),
                    "err": _np(st.error),
                    "cvel": _np(fm.client_states.velocities),
                    "cerr": _np(fm.client_states.errors),
                    "ms": {k: _np(v) for k, v in fm._model_state.items()}})
    return out


def body_rounds_and_single(cg, spec):
    """``body_rounds`` on this group, and on rank 0 also without a group
    (the single-device round of the same runs; None on other ranks)."""
    return (body_rounds(cg, spec),
            body_rounds(None, spec) if cg.rank == 0 else None)


def body_participation(cg, spec):
    """``spec["runs"]``: argv lists with the participation layer's flags;
    each runs ``spec["batches"]`` through a fresh model on this group with
    the layer attached. Per run and round: the weights, the cohort record
    and the counters. Each run also saves its run state after
    ``spec["save_at"]`` rounds and restores it into a fresh model, which
    runs the rest: its final weights come back as ``resumed_w``, with the
    count of held sums the file carried."""
    from commefficient_torch.federated.aggregator import LambdaLR
    from commefficient_torch.federated.checkpoint import (
        load_run_state,
        save_run_state,
    )
    from commefficient_torch.federated.participation import (
        attach_participation,
    )

    out = []
    for n, argv in enumerate(spec["runs"]):
        fm, opt = _resnet9_model(spec, cg, argv)
        ctl = attach_participation(fm.args, fm)
        rounds = []
        for i, b in enumerate(spec["batches"]):
            h = fm.begin_round(b)
            opt.step()
            fm.finish_round(h)
            rounds.append({"w": _weights(fm), "cohort": h.cohort,
                           "counters": ctl.counters()})
            if i + 1 == spec["save_at"]:
                held = len(ctl.pending) + len(ctl.buffer)
                path = save_run_state(
                    f"{spec['dir']}/part{n}/run_state_ep1", fm, opt,
                    LambdaLR(opt, lambda s: spec["lr"]), next_epoch=1)
        fm2, opt2 = _resnet9_model(spec, cg, argv, init=False)
        attach_participation(fm2.args, fm2)
        load_run_state(path, fm2, opt2, LambdaLR(opt2, lambda s: spec["lr"]))
        for b in spec["batches"][spec["save_at"]:]:
            h = fm2.begin_round(b)
            opt2.step()
            fm2.finish_round(h)
        out.append({"rounds": rounds, "resumed_w": _weights(fm2),
                    "held_at_save": held})
    return out


def body_gpt2_dropout(cg, spec):
    """One fused GPT-2 round with dropout on this group (or, with
    ``spec["single"]``, without a group on rank 0): the per-slot
    metrics and every dropout draw of the round's generator."""
    import torch

    from commefficient_torch.config import parse_args
    from commefficient_torch.federated import FedModel, FedOptimizer
    from commefficient_torch.federated.losses import make_gpt2_losses
    from commefficient_torch.models.gpt2 import GPT2DoubleHeads

    group = None if spec.get("single") else cg
    if group is None and cg.rank != 0:
        return None
    args = parse_args(argv=spec["argv"] + ["--device", "cpu"])
    m = GPT2DoubleHeads(vocab_size=64, n_positions=8, n_embd=16, n_layer=1,
                        n_head=2, dropout=0.1)
    train, val = make_gpt2_losses(m)
    draws = []
    inner = train.draw_rng

    def spy(gen, micro):
        keep = inner(gen, micro)
        draws.append(keep.numpy().copy())
        return keep

    train.draw_rng = spy
    fm = FedModel(m, train, args, val, num_clients=spec["num_clients"],
                  device="cpu", group=group)
    opt = FedOptimizer(fm, args)
    opt.set_lr_factor(0.1)
    res = fm({k: torch.as_tensor(v).numpy() for k, v in
              spec["batch"].items()})
    opt.step()
    return {"res": res, "draws": draws, "w": _weights(fm)}


def body_checkpoint(cg, spec):
    """Run a plan, save its run state, restore it into each of
    ``spec["restore"]`` argv (same group), and report the restored server
    state (this rank's) and the weights."""
    import warnings

    from commefficient_torch.federated.checkpoint import (
        load_run_state,
        save_run_state,
    )
    from commefficient_torch.federated.aggregator import LambdaLR

    fm, opt = _resnet9_model(spec, cg)
    sched = LambdaLR(opt, lambda s: spec["lr"])
    for b in spec["batches"]:
        sched.step()
        fm(b)
        opt.step()
    path = save_run_state(f"{spec['dir']}/run_state_ep1", fm, opt, sched,
                          next_epoch=1)
    st = opt.server_state
    out = {"saved": {"vel": _np(st.velocity), "err": _np(st.error),
                     "qres": _np(st.qres), "dres": _np(st.dres),
                     "w": _weights(fm)}, "restored": []}
    for argv in spec["restore"]:
        fm2, opt2 = _resnet9_model(spec, cg, argv, init=False)
        sched2 = LambdaLR(opt2, lambda s: spec["lr"])
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            load_run_state(path, fm2, opt2, sched2)
        st2 = opt2.server_state
        # one more round from the restored state
        fm2(spec["batches"][0])
        opt2.step()
        out["restored"].append({
            "vel": _np(st2.velocity), "err": _np(st2.error),
            "qres": _np(st2.qres), "dres": _np(st2.dres),
            "warnings": [str(w.message) for w in caught],
            "w_next": _weights(fm2)})
    return out


def cli_cv_train(init_method, spec):
    """``cv_train.main`` as a rank of ``torchrun`` would run it."""
    os.environ.update(spec["env"])
    from commefficient_torch import cv_train

    summary = cv_train.main(spec["argv"], init_method=init_method)
    return {k: float(v) for k, v in summary.items()}


def cli_gpt2_train(init_method, spec):
    """``gpt2_train.train`` as a rank of ``torchrun`` would run it; with
    ``spec["raises"]``, the message of the ``AssertionError`` it raises."""
    os.environ.update(spec["env"])
    from commefficient_torch import gpt2_train

    if spec.get("raises"):
        try:
            gpt2_train.train(spec["argv"], init_method=init_method)
        except AssertionError as e:
            return {"error": str(e)}
        return {"error": None}
    stats = gpt2_train.train(spec["argv"], init_method=init_method)
    return {k: float(v) for k, v in stats.items()}


# --------------------------------------------------------------------------
# the observability plane and the guard on one server step
# --------------------------------------------------------------------------

def flat_model(d):
    """A stand-in for a model of ``d`` parameters in one flax leaf
    (``params/w``, kind ``asis``): enough for ``FedModel`` to lay out the
    flat vector when a test hands the server step its round context
    directly."""
    import torch

    class Flat(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(d))

        def jax_param_path(self, name):
            return ("params", "w")

        def jax_param_kind(self, name):
            return "asis"

        def initial_model_state(self):
            return {}

    return Flat()


def obs_server_step(c, group=None):
    """One server step of ``FedModel`` (``c["argv"]``: telemetry, guards)
    from a round context built of ``c``'s arrays: this rank's transmit
    (the all-reduced one without ``--server_shard``), the weights
    ``ps0``, the state (this rank's slices of ``vel0`` / ``err0`` in the
    sharded dense modes). ``c["poison"]``: ``--inject_fault``'s write of
    element 0 of the transmit (rank 0's partial under ``--server_shard``).
    Returns the step's outputs and the update of the same step recomputed
    (for the JAX package's ``device_round_metrics`` on the same planes)."""
    import torch

    from commefficient_torch.config import parse_args
    from commefficient_torch.federated import FedModel, FedOptimizer
    from commefficient_torch.federated import server as S
    from commefficient_torch.federated.rounds import RoundContext

    args = parse_args(argv=list(c["argv"]) + ["--device", "cpu"])
    d = c["d"]

    def loss(*a):
        raise AssertionError("the client phase does not run here")

    fm = FedModel(flat_model(d), loss, args, num_clients=4,
                  init_params=_t(c["ps0"]), device="cpu", group=group)
    opt = FedOptimizer(fm, args)
    sharded = fm.round_config.server_shard
    n = group.size if sharded else 1
    r = group.rank if sharded else 0
    st = opt.server_state
    vel0, err0 = _t(c["vel0"]), _t(c["err0"])
    if sharded and not c["mode"].startswith("sketch"):
        per = st.velocity.shape[0]
        sl = slice(r * per, (r + 1) * per)
        pad = per * n - d
        vel0 = torch.nn.functional.pad(vel0, (0, pad))[sl]
        err0 = torch.nn.functional.pad(err0, (0, pad))[sl]
    st = st._replace(velocity=vel0.clone(), error=err0.clone())
    opt.server_state = st
    tr = _t(c["transmits"][r] if sharded else c["transmits"].sum(0)
            / np.float32(c["count"]))
    count = torch.tensor(c["count"], dtype=torch.float32)
    ids = torch.arange(2)
    fm._round_ctx = RoundContext(tr, ids, torch.ones(2), None, None, None,
                                 None, None, count if sharded else None)
    if c.get("poison"):
        fm._poison_transmit(0, float("nan"))
    ctx = fm._round_ctx
    lr = c["lr"]
    ps = fm.ps_weights
    out = fm.steps.server_step(ps, st, fm.client_states, ctx, lr, fm._rng,
                               sr=fm.sr_generators(0))
    new_ps, new_st, _, ok, tel = out
    if sharded:
        upd, _, _ = S.sharded_server_update(
            ctx.gradient, st, fm.server_config, lr, count, group,
            sketch=fm.sketch, layout=fm.layout,
            plan=fm.round_config.collective_plan, sr=fm.sr_generators(0))
    else:
        upd, _ = S.server_update(ctx.gradient, st, fm.server_config, lr,
                                 sketch=fm.sketch, layout=fm.layout)
    return {"tel": _np(tel), "ok": bool(ok), "transmit": _np(ctx.gradient),
            "update": _np(upd), "ps": _np(ps), "new_ps": _np(new_ps),
            "vel": _np(new_st.velocity), "err": _np(new_st.error),
            "qres": _np(new_st.qres), "dres": _np(new_st.dres),
            "old_vel": _np(st.velocity), "old_err": _np(st.error)}


def body_observability(cg, cases):
    """``obs_server_step`` of each case on this rank of the group."""
    return [obs_server_step(c, cg) for c in cases]


# --------------------------------------------------------------------------
# per-client state off the card
# --------------------------------------------------------------------------

def body_offload(cg, spec):
    """``spec["runs"]``: ``(argv, env)`` pairs, ``env`` forcing the memory
    plan's tier through its budget overrides; each runs
    ``spec["batches"]`` through a fresh model on this group (the disk
    tier under ``spec["dir"]/off<n>/rank<r>``). Per run: the tier, the
    weights after each round, and the final client rows."""
    out = []
    for n, (argv, env) in enumerate(spec["runs"]):
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            fm, opt = _resnet9_model(
                spec, cg, list(argv) + ["--state_dir",
                                        f"{spec['dir']}/off{n}"])
            ws = []
            for b in spec["batches"]:
                h = fm.begin_round(b)
                opt.step()
                fm.finish_round(h)
                ws.append(_weights(fm))
            fm.drain_client_state()
            st = fm._row_store
            rows = ({m: st.read_full(m) for m in st.row_shapes}
                    if st is not None else
                    {m: _np(getattr(fm.client_states, m))
                     for m in ("velocities", "errors")})
            out.append({"tier": fm.memory_plan.placement, "w": ws,
                        "rows": rows,
                        "dirs": sorted(os.listdir(f"{spec['dir']}/off{n}"))
                        if st is not None else None})
            fm.finalize()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    return out


# --------------------------------------------------------------------------
# the 2-D (clients x shard) grid
# --------------------------------------------------------------------------

class TorchTiny:
    """The port's copy of the JAX tests' ``nn.Dense(4, use_bias=False)``
    on 3 inputs: one ``Dense_0/kernel`` leaf (built in the child, where
    ``torch`` is imported)."""

    @staticmethod
    def make():
        import torch

        class Tiny(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.kernel = torch.nn.Parameter(torch.zeros(4, 3))

            def jax_param_path(self, name):
                return ("Dense_0", "kernel")

            def jax_param_kind(self, name):
                return "dense"

            def initial_model_state(self):
                return {}

        return Tiny()


def tiny_loss(params, model_state, batch, rng, train):
    """The JAX tests' loss of the tiny Dense model: the masked sum of the
    mean squared error."""
    import torch

    pred = batch["inputs"] @ params["kernel"].T
    err = pred - batch["targets"]
    mask = batch["mask"]
    return torch.sum(torch.square(err).mean(-1) * mask), (), \
        torch.sum(mask), model_state


def grid_of(num_workers: int, num_devices: int, shard: int, nodes: int = 1):
    """The client grid over this spawn's process group, whose ranks are
    the tuple indices."""
    import torch

    from commefficient_torch.parallel.mesh import make_client_group

    return make_client_group(num_workers, num_devices, torch.device("cpu"),
                             shard_devices=shard, nodes=nodes)


def _carry(x):
    if isinstance(x, tuple):
        return tuple(_np(v) for v in x)
    return _np(x)


def _tiny_model(spec, run, group, init=True):
    from commefficient_torch.config import parse_args
    from commefficient_torch.convert import flat_from_jax
    from commefficient_torch.federated import FedModel, FedOptimizer
    from commefficient_torch.federated.aggregator import LambdaLR
    from commefficient_torch.ops.flat import ParamLayout

    args = parse_args(argv=list(run["argv"]) + ["--device", "cpu"])
    model = TorchTiny.make()
    fm = FedModel(model, tiny_loss, args, num_clients=spec["num_clients"],
                  init_params=flat_from_jax(spec["flat0"],
                                            ParamLayout(model))
                  if init else None, device="cpu", group=group)
    opt = FedOptimizer(fm, args)
    opt.set_lr_factor(spec["lr"])
    sched = LambdaLR(opt, lambda s: spec["lr"])
    return fm, opt, sched


def _server_state(opt):
    st = opt.server_state
    return {"vel": _np(st.velocity), "err": _np(st.error),
            "qres": _carry(st.qres), "dres": _carry(st.dres)}


def body_grid_rounds(cg, spec):
    """``spec["runs"]``: each ``{"argv", "num_devices", "shard"}`` runs
    ``spec["batches"]`` through a fresh tiny model on its grid of this
    spawn's ranks. Per run: the grid, the lowering, the weights after each
    round, the server state, and with ``"save"`` the run state written
    after ``spec["save_at"]`` rounds and restored on each grid of
    ``"restore"`` (``(num_devices, shard)``), which runs the remaining
    rounds."""
    from commefficient_torch.federated.checkpoint import save_run_state

    out = []
    for i, run in enumerate(spec["runs"]):
        group = grid_of(spec["W"], run["num_devices"], run["shard"])
        if run.get("load"):
            out.append(_restored_rounds(spec, run, group, run["load"],
                                        spec["batches"]))
            continue
        fm, opt, sched = _tiny_model(spec, run, group)
        rec = {"axes": group.server_axes, "sizes": group.axis_sizes,
               "rank": group.rank, "lowering": fm._plan_lowering,
               "plan": fm.collective_plan.spec(), "w": [],
               "init": _server_state(opt)}
        path = None
        for r, b in enumerate(spec["batches"]):
            fm(b)
            opt.step()
            rec["w"].append(_weights(fm))
            if run.get("save") and r + 1 == spec["save_at"]:
                path = save_run_state(f"{spec['dir']}/grid{i}/rs", fm, opt,
                                      sched, next_epoch=1)
        rec["state"] = _server_state(opt)
        if path is not None:
            argvs = run.get("restore_argvs") or [None] * len(run["restore"])
            rec["restored"] = []
            for (nd, sh), argv in zip(run["restore"], argvs):
                g2 = grid_of(spec["W"], nd, sh)
                rrun = dict(run, argv=argv or run["argv"])
                if nd * sh != run["num_devices"] * run["shard"] or \
                        (nd, sh) != (run["num_devices"], run["shard"]):
                    rrun["argv"] = _regrid(rrun["argv"], nd, sh)
                rec["restored"].append(_restored_rounds(
                    spec, rrun, g2, path + ".npz" if not
                    path.endswith(".npz") else path,
                    spec["batches"][spec["save_at"]:]))
        out.append(rec)
    return out


def _regrid(argv, num_devices: int, shard: int):
    """``argv`` with its grid flags set to ``num_devices`` x ``shard``."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a in ("--num_devices", "--shard_devices"):
            skip = True
            continue
        out.append(a)
    return out + ["--num_devices", str(num_devices), "--shard_devices",
                  str(shard)]


def _restored_rounds(spec, run, group, path, batches):
    """A fresh tiny model on ``group`` restored from the run state
    ``path``: its server state and weights at load, the carry warnings,
    the weights after each of ``batches`` and the final server state."""
    import warnings

    from commefficient_torch.federated.checkpoint import load_run_state

    fm, opt, sched = _tiny_model(spec, run, group, init=False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        load_run_state(path, fm, opt, sched)
    got = {"at_load": _server_state(opt), "w_load": _weights(fm),
           "warnings": [str(w.message) for w in caught
                        if "carry" in str(w.message)],
           "w": []}
    for b in batches:
        fm(b)
        opt.step()
        got["w"].append(_weights(fm))
    got["state"] = _server_state(opt)
    return got


def body_hier(cg, cases):
    """Each case: one hierarchical collective (``op``: ``scatter``,
    ``psum`` or ``gather``) over ``lowering`` on the (clients = 2) x
    (shard = 2) grid of this spawn's 4 ranks, with this rank's ``x``, its
    per-level ``residuals`` and the JAX package's per-level uniforms
    ``u`` (stacked by tuple index). Returns the output and the new
    carries."""
    from commefficient_torch.ops import collectives as C

    grid = grid_of(4, 2, 2)
    p = grid.rank
    fn = {"scatter": C.hierarchical_psum_scatter,
          "psum": C.hierarchical_psum,
          "gather": C.hierarchical_all_gather}
    out = []
    for case in cases:
        low = tuple(tuple(lv) for lv in case["lowering"])

        def level(seq):
            if seq is None:
                return None
            return [None if a is None else _t(a[p]) for a in seq]

        got, new = fn[case["op"]](
            _t(case["x"][p]), low, grid,
            residuals=level(case.get("residuals")), block=case["block"],
            u=level(case["u"]))
        out.append({"out": _np(got), "res": _carry(new)})
    return out


def body_server_2d(cg, cases):
    """Each case: one ``sharded_server_update`` on the (clients = 2) x
    (shard = 2) grid under a per-axis ``plan`` resolved on the grid, with
    this rank's transmit and the JAX package's uniforms (``u``: per leg,
    per level, stacked by tuple index). Returns the update, the state and
    the old and new carries."""
    import torch

    from commefficient_torch.federated import server as S
    from commefficient_torch.ops.collectives import (
        parse_collective_plan,
        plan_lowering,
    )
    from commefficient_torch.ops.sketch import make_sketch

    out = []
    for c in cases:
        if c.get("force_dcn"):
            os.environ["COMMEFFICIENT_FORCE_DCN_AXIS"] = c["force_dcn"]
        grid = grid_of(4, 2, 2)
        os.environ.pop("COMMEFFICIENT_FORCE_DCN_AXIS", None)
        p = grid.rank
        cfg = S.ServerConfig(mode=c["mode"], error_type=c["error_type"],
                             k=c["k"], grad_size=c["d"],
                             virtual_momentum=c["vm"])
        sk = layout = None
        if c["mode"] == "sketch":
            sk = make_sketch(c["d"], c["c"], c["r"], seed=c["seed"],
                             num_blocks=1, device="cpu")
            layout = sk.chunk_layout
        plan = parse_collective_plan(c["plan"])
        low = plan_lowering(plan, grid)
        st = S.init_server_state(cfg, sk, device="cpu", shard_n=grid.size,
                                 plan=plan, lowering=low,
                                 axis_sizes=grid.axis_sizes)
        count = torch.tensor(c["count"], dtype=torch.float32)
        rounds = []
        for rnd, u_round in enumerate(c["u"]):
            u = {leg: tuple(None if a is None else _t(a[p]) for a in lv)
                 for leg, lv in u_round.items()}
            old = st
            upd, st, rs = S.sharded_server_update(
                _t(c["transmits"][rnd][p]), st, cfg, c["lr"], count, grid,
                sketch=sk, layout=layout, plan=plan, lowering=low, u=u)
            rounds.append({"update": _np(upd), "vel": _np(st.velocity),
                           "err": _np(st.error), "resketched": _np(rs),
                           "qres": _carry(st.qres), "dres": _carry(st.dres),
                           "old_qres": _carry(old.qres),
                           "old_dres": _carry(old.dres)})
        out.append({"lowering": low, "rounds": rounds})
    return out


# --------------------------------------------------------------------------
# sequence parallelism (the seq axis, ring and Ulysses attention)
# --------------------------------------------------------------------------

def body_seq_attention(cg, cases):
    """Each case: ``ring_attention`` or ``ulysses_attention`` over this
    spawn's ranks as one seq group, on this rank's slice of the global
    ``q, k, v`` (``(B, T, H, D)``, cut on T in rank order); the local
    output, and the gradients of ``sum(out * ct)`` by the local ``q, k,
    v``."""
    import torch

    from commefficient_torch.parallel import ring_attention, ulysses_attention

    n, r = cg.size, cg.rank
    out = []
    for c in cases:
        T = c["q"].shape[1]
        sl = slice(r * T // n, (r + 1) * T // n)
        q, k, v = (_t(c[x][:, sl]).requires_grad_() for x in "qkv")
        fn = {"ring": ring_attention, "ulysses": ulysses_attention}[c["impl"]]
        o = fn(q, k, v, cg, causal=c["causal"])
        grads = torch.autograd.grad((o * _t(c["ct"][:, sl])).sum(),
                                    (q, k, v))
        out.append({"out": _np(o), "grads": [_np(g) for g in grads]})
    return out


def tiny_gpt2(spec, impl=None, seq_group=None, model_group=None,
              expert_group=None):
    """The tests' tiny GPT-2 (``spec["model"]``, which may name
    ``n_experts``), seq-parallel over ``seq_group`` with ``impl``, its
    heads over ``model_group`` and its experts over ``expert_group``, or
    dense."""
    from commefficient_torch.models.gpt2 import GPT2DoubleHeads

    geometry = ({"attn_impl": impl, "seq_group": seq_group}
                if seq_group is not None else {})
    return GPT2DoubleHeads(**spec["model"], **geometry,
                           model_group=model_group,
                           expert_group=expert_group)


def body_seq_forward(cg, spec):
    """The seq-parallel GPT-2 forward over this spawn's ranks as one seq
    group, under each of ``spec["impls"]``, from the flat JAX-order
    weights ``spec["flat0"]``: this rank's LM logits (its slice of the
    sequence) and the multiple-choice logits."""
    import torch
    from torch.func import functional_call

    from commefficient_torch.convert import flat_from_jax
    from commefficient_torch.ops.flat import ParamLayout

    n, r = cg.size, cg.rank
    T = spec["ids"].shape[-1]
    sl = slice(r * T // n, (r + 1) * T // n)
    out = {}
    for impl in spec["impls"]:
        m = tiny_gpt2(spec, impl, cg)
        layout = ParamLayout(m)
        w = flat_from_jax(spec["flat0"], layout)
        with torch.no_grad():
            lm, mc = functional_call(
                m, layout.params(w), (_t(spec["ids"][..., sl]),),
                {"token_type_ids": _t(spec["tti"][..., sl]),
                 "mc_token_ids": _t(spec["mc"])})
        out[impl] = {"lm": _np(lm), "mc": _np(mc)}
    return out


def body_seq_rounds(cg, spec):
    """``spec["runs"]``: each ``{"argv", "num_devices", "seq", "impl"}``
    runs ``spec["batches"]`` through a fresh tiny GPT-2 FedModel on its
    grid of this spawn's ranks (``impl`` None: the dense model; with
    ``"single"``: without a group, on rank 0 alone). Per run:
    the grid, this rank's weights after each round, the round's loss
    metrics and its transmit table (the round's gradient sketch, divided
    by the count), and with ``"dropout"`` each dropout draw of the
    round (the keep masks) and the round generator's state after it."""
    import torch

    from commefficient_torch.config import parse_args
    from commefficient_torch.convert import flat_from_jax
    from commefficient_torch.federated import FedModel, FedOptimizer
    from commefficient_torch.federated.losses import make_gpt2_losses
    from commefficient_torch.ops.flat import ParamLayout
    from commefficient_torch.parallel.mesh import (
        make_client_group,
        requested_axes,
    )
    from commefficient_torch.parallel.pipeline import make_gpt2_pp_losses

    out = []
    for run in spec["runs"]:
        args = parse_args(argv=list(run["argv"]) + ["--device", "cpu"])
        if run.get("single"):
            # the single-device round, on rank 0 alone
            if cg.rank != 0:
                out.append(None)
                continue
            group = None
        else:
            group = make_client_group(spec["W"], run["num_devices"],
                                      torch.device("cpu"),
                                      **dict(requested_axes(args),
                                             seq_devices=run["seq"]))
        seq_group = (group.seq if group is not None
                     and args.seq_parallel != "none" else None)
        model_group = group.model if group is not None else None
        expert_group = group.expert if group is not None else None
        stage_group = group.stage if group is not None else None
        mspec = dict(spec, model=dict(
            spec["model"], dropout=run.get("dropout", 0.0),
            n_experts=args.n_experts, moe_dispatch=args.moe_dispatch,
            moe_capacity_factor=args.moe_capacity_factor))
        m = tiny_gpt2(mspec, run["impl"], seq_group, model_group,
                      expert_group)
        aux = args.moe_aux_coef if args.n_experts else 0.0
        if stage_group is not None:
            train, val = make_gpt2_pp_losses(
                m, stage_group, n_micro=args.pp_microbatches,
                moe_aux_coef=aux)
        else:
            train, val = make_gpt2_losses(m, seq_group=seq_group,
                                          moe_aux_coef=aux)
        draws = []
        if run.get("dropout"):
            inner = train.draw_rng

            def spy(gen, micro, inner=inner):
                keep = inner(gen, micro)
                draws.append(keep.numpy().copy())
                return keep

            train.draw_rng = spy
        fm = FedModel(m, train, args, val, num_clients=spec["num_clients"],
                      init_params=flat_from_jax(spec["flat0"],
                                                ParamLayout(m)),
                      device="cpu", group=group)
        opt = FedOptimizer(fm, args)
        opt.set_lr_factor(spec["lr"])
        rec = {"seq_axis": fm.worker_config.seq_axis,
               "model_axis": fm.worker_config.model_axis,
               "expert_axis": fm.worker_config.expert_axis,
               "pp_axis": fm.worker_config.pp_axis, "w": [],
               "res": [], "table": []}
        if group is not None:
            rec.update(rank=group.rank, size=group.size,
                       seq=None if group.seq is None else
                       (group.seq.rank, group.seq.size),
                       model=None if group.model is None else
                       (group.model.rank, group.model.size),
                       expert=None if group.expert is None else
                       (group.expert.rank, group.expert.size),
                       stage=None if group.stage is None else
                       (group.stage.rank, group.stage.size),
                       is_main=group.is_main, topology=group.topology(),
                       process_rank=group.process_rank)
        for b in spec["batches"]:
            h = fm.begin_round(b)
            rec["table"].append(_np(fm._round_ctx.gradient))
            opt.step()
            rec["res"].append(fm.finish_round(h))
            rec["w"].append(_weights(fm))
        if draws:
            rec["draws"] = draws
            rec["rng_state"] = fm._rng.get_state().numpy().copy()
        fm.train(False)
        rec["val"] = fm(spec["val"])
        out.append(rec)
    return out


# --------------------------------------------------------------------------
# tensor parallelism and experts (the model and expert axes)
# --------------------------------------------------------------------------

def _grid_of_spawn(cg, seq: int = 1, model: int = 1, expert: int = 1,
                   n_experts: int = 0, stage: int = 1):
    """This spawn's ranks as one tuple index with the inner axes asked
    for (a grid of one client slot)."""
    import torch

    from commefficient_torch.parallel.mesh import make_client_group

    g = make_client_group(1, 1, torch.device("cpu"), seq_devices=seq,
                          model_devices=model, expert_devices=expert,
                          n_experts=n_experts, pipeline_devices=stage)
    assert g.active and g.inner_size == cg.size, (g, cg.size)
    return g


def body_mp_forward(cg, spec):
    """The GPT-2 forward under each of ``spec["cases"]`` (``{"seq",
    "model", "expert", "impl"}``) over this spawn's ranks, from the flat
    JAX-order weights ``spec["flat0"]``: this rank's LM logits (its slice
    of the sequence), the multiple-choice logits and the aux losses."""
    import torch
    from torch.func import functional_call

    from commefficient_torch.convert import flat_from_jax
    from commefficient_torch.ops.flat import ParamLayout

    out = []
    for c in spec["cases"]:
        g = _grid_of_spawn(cg, c.get("seq", 1), c.get("model", 1),
                           c.get("expert", 1),
                           spec["model"].get("n_experts", 0))
        n = g.seq.size if g.seq is not None else 1
        r = g.seq.rank if g.seq is not None else 0
        T = spec["ids"].shape[-1]
        sl = slice(r * T // n, (r + 1) * T // n)
        m = tiny_gpt2(spec, c.get("impl"), g.seq, g.model, g.expert)
        layout = ParamLayout(m)
        w = flat_from_jax(spec["flat0"], layout)
        with torch.no_grad():
            lm, mc, aux = functional_call(
                m, layout.params(w), (_t(spec["ids"][..., sl]),),
                {"token_type_ids": _t(spec["tti"][..., sl]),
                 "mc_token_ids": _t(spec["mc"]), "return_aux": True})
        out.append({"lm": _np(lm), "mc": _np(mc), "aux": _np(aux),
                    "process_rank": g.process_rank})
    return out


def body_moe_mlp(cg, spec):
    """``MoEMLP`` under each of ``spec["cases"]`` (``{"seq", "expert",
    "dispatch", "cf"}``) over this spawn's ranks, from the flax leaves
    ``spec["params"]`` on ``spec["x"]`` ``(B, T, C)`` (cut on T over the
    seq axis): this rank's output, the aux, and the gradients of ``sum(out
    * ct) + aux`` by the input and each leaf."""
    import torch

    from commefficient_torch.parallel.moe import MoEMLP

    C, E = spec["x"].shape[-1], spec["n_experts"]
    out = []
    for c in spec["cases"]:
        g = _grid_of_spawn(cg, c.get("seq", 1), 1, c.get("expert", 1), E)
        n = g.seq.size if g.seq is not None else 1
        r = g.seq.rank if g.seq is not None else 0
        T = spec["x"].shape[1]
        sl = slice(r * T // n, (r + 1) * T // n)
        mod = MoEMLP(C, E, expert_group=g.expert, seq_group=g.seq,
                     dispatch=c.get("dispatch", "dense"),
                     capacity_factor=c.get("cf", 1.25))
        with torch.no_grad():
            for k, v in spec["params"].items():
                getattr(mod, k).copy_(_t(v))
        x = _t(spec["x"][:, sl]).requires_grad_()
        y, aux = mod(x)
        loss = (y * _t(spec["ct"][:, sl])).sum() + aux
        names = sorted(spec["params"])
        grads = torch.autograd.grad(loss, [x] + [getattr(mod, k)
                                                 for k in names])
        out.append({"out": _np(y), "aux": float(aux),
                    "gx": _np(grads[0]),
                    "grads": {k: _np(gr) for k, gr in zip(names, grads[1:])}})
    return out


# --------------------------------------------------------------------------
# the pipeline (the stage axis)
# --------------------------------------------------------------------------

def body_pp_losses(cg, spec):
    """The pipelined GPT-2 losses under each of ``spec["cases"]`` (``{"stage",
    "n_micro", "seq", "impl", "expert", "coef", "bf16", "val"}``) over this
    spawn's ranks as one tuple index, from the flat JAX-order weights
    ``spec["flat0"]`` on ``spec["batch"]`` (one client; its token leaves
    cut over the seq axis): the train loss, the count and the gradient
    made whole over the seq, stage and expert axes (``worker.reconcile``;
    flat, JAX order), or with ``"val"`` the val sums."""
    import torch

    from commefficient_torch.convert import flat_from_jax
    from commefficient_torch.federated.rounds import (
        flat_scale,
        seq_slice,
        slice_scale_values,
    )
    from commefficient_torch.federated.worker import leaf_grads, reconcile
    from commefficient_torch.ops.flat import ParamLayout, leaf_segments
    from commefficient_torch.parallel.moe import ep_sliced_param
    from commefficient_torch.parallel.pipeline import make_gpt2_pp_losses

    out = []
    for c in spec["cases"]:
        model = dict(spec["model"], **c.get("model", {}))
        g = _grid_of_spawn(cg, c.get("seq", 1), 1, c.get("expert", 1),
                           model.get("n_experts", 0), c["stage"])
        m = tiny_gpt2({"model": model}, c.get("impl"), g.seq, None,
                      g.expert)
        layout = ParamLayout(m)
        w = flat_from_jax(spec[c.get("flat", "flat0")], layout)
        train, val = make_gpt2_pp_losses(
            m, g.stage, n_micro=c["n_micro"],
            compute_dtype=torch.bfloat16 if c.get("bf16") else None,
            moe_aux_coef=c.get("coef", 0.0))
        batch = seq_slice({k: _t(v) for k, v in spec[c.get(
            "batch", "batch")].items()}, ("input_ids", "token_type_ids",
                                          "lm_labels_shifted"), g.seq)
        if c.get("val"):
            with torch.no_grad():
                nll, (acc,), cnt, _ = val(layout.params(w), {}, batch, None,
                                          False)
            out.append({"nll": float(nll), "acc": float(acc),
                        "count": float(cnt)})
            continue
        leaves = layout.leaves(w)
        loss, _, cnt, _ = train(layout.params_of(leaves), {}, batch, None,
                                True)
        grad = layout.gather_grads(leaf_grads(loss, leaves),
                                   torch.empty_like(w))
        ep = None
        if g.expert is not None:
            ep = flat_scale(leaf_segments(layout), slice_scale_values(
                leaf_segments(layout), ep_sliced_param, g.expert.size))
        grad = reconcile(grad, g.seq, expert_group=g.expert, ep_scale=ep,
                         stage_group=g.stage)
        out.append({"loss": float(loss), "count": float(cnt),
                    "g": _np(grad), "process_rank": g.process_rank})
    return out
