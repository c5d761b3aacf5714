"""Equal-start trace of a ``learning_midscale`` leg through both packages.

The reference is the JAX package at ``--num_devices 1``; the side held
against it is the port on the CPU (``--against port``) or the JAX package
again with its slots over the 8-device CPU mesh, as the JAX script runs
them (``--against jax8``: the same math with the client sum in another
order). Both sides start from the reference's initial weights and
BatchNorm statistics (``convert.flat_from_jax``, ``model_state_from_flax``
for the port), read the batches of the leg's own loader (the port's
``get_data_loaders`` on the leg's argv after ``np.random.seed(seed)``, as
``cv_train`` does; the two packages' loaders give the same batches),
follow the leg's LR schedule through each package's ``LambdaLR`` and
round engine, and evaluate on the test set at each epoch's end. Every
round it records each quantity's distance from the parity tolerances of
``tests/test_torch_batchnorm.py`` as ``max |other - jax| / (atol + rtol *
|jax|)`` (at most 1 inside the tolerance):

- ``loss``: the per-image train losses (``rtol=1e-4``);
- ``weights``: the flat weights (``rtol=1e-4, atol=1e-6``), with the
  largest absolute difference and the relative L2 distance, and the
  round's update (the change of the weights) as a relative L2 distance;
- ``stats``: every BatchNorm running mean and variance (``rtol=1e-4,
  atol=1e-5``);
- ``kept``: the overlap of the two rounds' changed coordinates.

Two more modes: ``--grad_check`` (the first round's summed client
gradient in float32 and float64 in each package, against the JAX
package's float64 one) and ``--port_spread S,S,...`` (the port alone from
the reference's weights, unperturbed and with each weight scaled by ``1 +
eps * N(0, 1)`` for each perturbation seed: its test accuracy each epoch).

    JAX_PLATFORMS=cpu python tests/torch_learning_trace.py big_uncompressed \
        --out trace.json [--seed S] [--epochs N] [--rounds N] \
        [--against port|jax8 | --grad_check | --port_spread 0,1,2 --eps E]

Imports both packages, so it runs on the CPU only, like the tests.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)
# the JAX script's 8-device CPU mesh, for ``--against jax8``
if "xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               "--xla_force_host_platform_device_count=8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from commefficient_tpu.config import parse_args as j_parse  # noqa: E402
from commefficient_tpu.federated import FedModel as JFedModel  # noqa: E402
from commefficient_tpu.federated import FedOptimizer as JFedOptimizer  # noqa: E402
from commefficient_tpu.federated import LambdaLR as JLambdaLR  # noqa: E402
from commefficient_tpu.federated import (  # noqa: E402
    PipelinedRoundEngine as JEngine,
)
from commefficient_tpu.federated.losses import make_cv_losses as j_losses  # noqa: E402
from commefficient_tpu.models import ResNet9 as JResNet9  # noqa: E402
from commefficient_torch.config import parse_args as t_parse  # noqa: E402
from commefficient_torch.convert import (  # noqa: E402
    flat_from_jax,
    model_state_from_flax,
)
from commefficient_torch.cv_train import get_data_loaders  # noqa: E402
from commefficient_torch.federated import FedModel, FedOptimizer  # noqa: E402
from commefficient_torch.federated import LambdaLR  # noqa: E402
from commefficient_torch.federated import PipelinedRoundEngine  # noqa: E402
from commefficient_torch.federated.losses import make_cv_losses as t_losses  # noqa: E402
from commefficient_torch.models import ResNet9  # noqa: E402
from commefficient_torch.ops.flat import ParamLayout  # noqa: E402
from commefficient_torch.scripts.learning_midscale import LEGS, leg_argv  # noqa: E402
from commefficient_torch.utils import PiecewiseLinear  # noqa: E402

LOSS_TOL = (1e-4, 0.0)
WEIGHT_TOL = (1e-4, 1e-6)
STAT_TOL = (1e-4, 1e-5)


def tol_ratio(t, j, rtol, atol) -> float:
    """``max |t - j| / (atol + rtol |j|)``: at most 1 inside
    ``np.testing.assert_allclose(t, j, rtol, atol)``."""
    t = np.asarray(t, np.float64)
    j = np.asarray(j, np.float64)
    return float(np.max(np.abs(t - j) / (atol + rtol * np.abs(j))))


def channels_of(spec: str):
    pre, l1, l2, l3 = (int(x) for x in spec.split(","))
    return (("prep", pre), ("layer1", l1), ("layer2", l2), ("layer3", l3))


def leg_args(leg, data_root, seed=None, epochs=None):
    """Both packages' parsed args for the leg (JAX's without telemetry;
    the port's on the CPU), at ``seed`` / ``epochs`` when given."""
    argv = leg_argv(leg, data_root, seed)
    if epochs is not None:
        argv[argv.index("--num_epochs") + 1] = str(epochs)
    jargs = j_parse(argv=argv + ["--no_telemetry"])
    targs = t_parse(argv=argv + ["--no_telemetry", "--device", "cpu"])
    return jargs, targs


class JaxSide:
    """The JAX package's model, optimizer, scheduler and engine; its
    initial weights and statistics come from ``model.init`` at the seed."""

    def __init__(self, jargs, ch, n, sched, spe):
        jm = JResNet9(do_batchnorm=True, channels=ch)
        jtrain, jval = j_losses(jm, has_batch_stats=True)
        self.fm = JFedModel(jm, jtrain, jargs, jval,
                            input_shape=(32, 32, 3), num_clients=n)
        opt = JFedOptimizer(self.fm, jargs)
        self.engine = JEngine(self.fm, opt, JLambdaLR(
            opt, lr_lambda=lambda s: sched(s / spe)))
        self.seconds = 0.0

    def weights(self):
        return np.asarray(ravel_pytree(self.fm.params)[0])

    def stats(self):
        return {k: v.numpy() for k, v in model_state_from_flax(
            jax.tree_util.tree_map(np.asarray, self.fm._model_state)).items()}


class PortSide:
    """The port's model, optimizer, scheduler and engine on the CPU, from
    the given flat weights and statistics."""

    def __init__(self, targs, ch, n, sched, spe, flat0, state0):
        tm = ResNet9(channels=ch, do_batchnorm=True)
        ttrain, tval = t_losses(tm)
        self.fm = FedModel(tm, ttrain, targs, tval, num_clients=n,
                           init_params=flat_from_jax(flat0, ParamLayout(tm)),
                           device="cpu")
        assert list(self.fm._model_state) == list(state0)
        for k, v in state0.items():
            self.fm._model_state[k] = torch.from_numpy(v.copy())
        opt = FedOptimizer(self.fm, targs)
        self.engine = PipelinedRoundEngine(self.fm, opt, LambdaLR(
            opt, lr_lambda=lambda s: sched(s / spe)))
        self.seconds = 0.0

    def weights(self):
        fm = self.fm
        w = (fm.layout.unchunk(fm.ps_weights) if fm.layout is not None
             else fm.ps_weights)
        return w.numpy().copy()

    def stats(self):
        return {k: v.numpy().copy() for k, v in self.fm._model_state.items()}


def run_round(side, batch):
    """One round through the side's engine: its per-image losses and
    accuracies."""
    t0 = time.perf_counter()
    res = side.engine.submit(batch) + side.engine.drain()
    (loss, acc, _, _), = [r.values for r in res]
    side.seconds += time.perf_counter() - t0
    return np.asarray(loss), np.asarray(acc)


def evaluate(side, loader):
    """The test set through the side's model in eval mode."""
    fm = side.fm
    fm.train(False)
    losses, accs = [], []
    for batch in loader:
        loss, acc = fm(batch)
        losses.extend(np.asarray(loss).tolist())
        accs.extend(np.asarray(acc).tolist())
    fm.train(True)
    return float(np.mean(losses)), float(np.mean(accs))


class Pair:
    """The reference (the JAX package at ``--num_devices 1``) and the side
    held against it for one leg, both from the reference's initial
    weights and statistics. ``against``: ``port`` (the port on the CPU)
    or ``jax8`` (the JAX package again, its slots over 8 CPU devices as
    the JAX script runs them: the same math with the client sum in
    another order, the reference's own sensitivity to it)."""

    def __init__(self, leg, data_root, seed=None, epochs=None,
                 against="port"):
        jargs, self.targs = leg_args(leg, data_root, seed, epochs)
        args = self.targs
        ch = channels_of(LEGS[leg][0])
        np.random.seed(args.seed)
        os.environ.setdefault("COMMEFFICIENT_SYNTHETIC_PER_CLASS", "64")
        self.train_loader, self.test_loader = get_data_loaders(args)
        n = self.train_loader.dataset.num_clients
        state = np.random.get_state()
        self.spe = spe = self.train_loader.steps_per_epoch()
        sched = PiecewiseLinear([0, args.pivot_epoch, args.num_epochs],
                                [0, args.lr_scale, 0])
        self.ref = JaxSide(jargs, ch, n, sched, spe)
        self.flat0 = self.ref.weights()
        if against == "port":
            self.other = PortSide(args, ch, n, sched, spe, self.flat0,
                                  self.ref.stats())
        else:
            j8 = copy.copy(jargs)
            j8.num_devices = 8
            self.other = JaxSide(j8, ch, n, sched, spe)
            assert np.array_equal(self.other.weights(), self.flat0)
        # neither package's construction draws from numpy's global RNG,
        # which the loader's sampler and transforms read
        assert _same_state(state, np.random.get_state())
        self.jw = self.tw = self.flat0

    def round(self, batch):
        """One round on both sides; the distances of their state."""
        state = np.random.get_state()
        jl, ja = run_round(self.ref, batch)
        assert _same_state(state, np.random.get_state())
        tl, ta = run_round(self.other, batch)
        jw, tw = self.ref.weights(), self.other.weights()
        js, ts = self.ref.stats(), self.other.stats()
        jsel = np.flatnonzero(jw != self.jw)
        tsel = np.flatnonzero(tw != self.tw)
        both = np.intersect1d(jsel, tsel).size
        jup = jw.astype(np.float64) - self.jw
        tup = tw.astype(np.float64) - self.tw
        self.jw, self.tw = jw, tw
        dw = np.abs(tw.astype(np.float64) - jw)
        return {
            "jax_loss": float(np.mean(jl)), "other_loss": float(np.mean(tl)),
            "jax_acc": float(np.mean(ja)), "other_acc": float(np.mean(ta)),
            "loss": tol_ratio(tl, jl, *LOSS_TOL),
            "weights": tol_ratio(tw, jw, *WEIGHT_TOL),
            "weights_max_abs": float(dw.max()),
            "weights_rel_l2": float(np.linalg.norm(dw)
                                    / np.linalg.norm(jw)),
            "update_rel_l2": float(np.linalg.norm(tup - jup)
                                   / np.linalg.norm(jup)),
            "stats": max(tol_ratio(ts[k], js[k], *STAT_TOL) for k in js),
            # a round that moves no weight on either side (all padding)
            # keeps the same, empty, set
            "kept": (both / max(jsel.size, tsel.size) if jsel.size
                     or tsel.size else 1.0),
        }

    def evaluate(self):
        jl, ja = evaluate(self.ref, self.test_loader)
        tl, ta = evaluate(self.other, self.test_loader)
        return {"jax_test_loss": jl, "jax_test_acc": ja,
                "other_test_loss": tl, "other_test_acc": ta}


def _same_state(a, b) -> bool:
    return a[0] == b[0] and np.array_equal(a[1], b[1]) and a[2:] == b[2:]


def trace(leg, data_root, seed=None, epochs=None, max_rounds=None,
          against="port", log=print):
    """Run the leg on both sides; one record a round, one an epoch."""
    pair = Pair(leg, data_root, seed, epochs, against)
    n_epochs = int(np.ceil(pair.targs.num_epochs))
    rounds, evals = [], []
    for epoch in range(n_epochs):
        for i, batch in enumerate(pair.train_loader):
            if i > pair.spe or (max_rounds and len(rounds) >= max_rounds):
                break
            t0 = time.time()
            rec = {"round": len(rounds), "epoch": epoch, **pair.round(batch)}
            rec["s"] = round(time.time() - t0, 2)
            rounds.append(rec)
            log(json.dumps(rec))
        if max_rounds and len(rounds) >= max_rounds:
            break
        ev = {"epoch": epoch + 1, **pair.evaluate()}
        evals.append(ev)
        log(json.dumps(ev))
    return {"leg": leg, "seed": pair.targs.seed, "against": against,
            "d": int(pair.flat0.size), "rounds": rounds, "evals": evals,
            "seconds": {"jax": pair.ref.seconds,
                        against: pair.other.seconds},
            "first_out": first_out(rounds)}


def port_spread(leg, data_root, eps, perturb_seeds, seed=None, log=print):
    """The port alone from the JAX package's initial weights, and from
    those weights with each coordinate scaled by ``1 + eps * N(0, 1)``
    (one draw a perturbation seed): the test accuracy and loss after each
    epoch, a run each. The spread of these runs is the port's own
    sensitivity, from one start, to a change of the weights' last bits."""
    jargs, targs = leg_args(leg, data_root, seed)
    ch = channels_of(LEGS[leg][0])
    os.environ.setdefault("COMMEFFICIENT_SYNTHETIC_PER_CLASS", "64")
    np.random.seed(targs.seed)
    train_loader, _ = get_data_loaders(targs)
    n = train_loader.dataset.num_clients
    spe = train_loader.steps_per_epoch()
    sched = PiecewiseLinear([0, targs.pivot_epoch, targs.num_epochs],
                            [0, targs.lr_scale, 0])
    ref = JaxSide(jargs, ch, n, sched, spe)
    flat0, stats0 = ref.weights(), ref.stats()
    del ref
    runs = {}
    for ps in [None] + list(perturb_seeds):
        # the leg's batches from its seed, as cv_train draws them
        np.random.seed(targs.seed)
        train_loader, test_loader = get_data_loaders(targs)
        w0 = flat0
        if ps is not None:
            noise = np.random.default_rng(ps).standard_normal(flat0.size)
            w0 = (flat0 * (1.0 + eps * noise)).astype(np.float32)
        side = PortSide(targs, ch, n, sched, spe, w0, stats0)
        evals = []
        for epoch in range(int(np.ceil(targs.num_epochs))):
            for i, batch in enumerate(train_loader):
                if i > spe:
                    break
                run_round(side, batch)
            loss, acc = evaluate(side, test_loader)
            evals.append({"epoch": epoch + 1, "test_loss": loss,
                          "test_acc": acc})
        key = "unperturbed" if ps is None else f"perturb{ps}"
        runs[key] = evals
        log(json.dumps({"run": key, **evals[-1]}))
    return {"leg": leg, "seed": targs.seed, "eps": eps, "runs": runs}


def grad_check(leg, data_root, seed=None, n_clients=None, jax32=True):
    """The first round's summed client gradient (each client's BatchNorm
    statistics its own, no weight decay) at the JAX package's initial
    weights, in float32 and in float64 in each package (the first
    ``n_clients`` clients of the round, default all; JAX's float32 one
    only with ``jax32``). Returns each gradient's distance from the JAX
    package's float64 one."""
    import contextlib

    import jax.numpy as jnp

    jargs, targs = leg_args(leg, data_root, seed)
    ch = channels_of(LEGS[leg][0])
    np.random.seed(targs.seed)
    os.environ.setdefault("COMMEFFICIENT_SYNTHETIC_PER_CLASS", "64")
    batch = next(iter(get_data_loaders(targs)[0]))
    clients = [{k: batch[k][c] for k in ("inputs", "targets", "mask")}
               for c in range(n_clients or len(batch["inputs"]))]
    jm = JResNet9(do_batchnorm=True, channels=ch)
    v = jm.init(jax.random.key(targs.seed),
                jnp.zeros((1, 32, 32, 3), jnp.float32), train=False)
    jtrain, _ = j_losses(jm, has_batch_stats=True)
    grads = {}
    specs = [("jax64", jnp.float64, True)]
    if jax32:
        specs.insert(0, ("jax32", jnp.float32, False))
    for name, dtype, x64 in specs:
        with (jax.enable_x64(True) if x64 else contextlib.nullcontext()):
            params, stats = jax.tree_util.tree_map(
                lambda x: x.astype(dtype), (v["params"], v["batch_stats"]))
            cl = [dict(cb, inputs=jnp.asarray(cb["inputs"], dtype))
                  for cb in clients]

            def jtotal(p):
                return sum(jtrain(p, stats, cb, None, True)[0]
                           for cb in cl)

            grads[name] = np.asarray(ravel_pytree(
                jax.jit(jax.grad(jtotal))(params))[0], np.float64)
    flat0 = np.asarray(ravel_pytree(v["params"])[0])
    tm = ResNet9(channels=ch, do_batchnorm=True)
    layout = ParamLayout(tm)
    params = layout.params(flat_from_jax(flat0, layout))
    state = model_state_from_flax(jax.tree_util.tree_map(
        np.asarray, v["batch_stats"]))
    tclients = [{k: torch.from_numpy(np.asarray(x)) for k, x in cb.items()}
                for cb in clients]
    for name, dtype in (("port32", None), ("port64", torch.float64)):
        loss = t_losses(tm, compute_dtype=dtype)[0]

        def ttotal(p):
            return sum(loss(p, state, cb, None, True)[0] for cb in tclients)

        grads[name] = layout.flatten(torch.func.grad(ttotal)(params)
                                     ).double().numpy()
    ref = grads["jax64"]
    res = {"leg": leg, "d": int(ref.size), "clients": len(clients),
           "ref_norm": float(np.linalg.norm(ref))}
    for name in [n for n in ("jax32", "port32", "port64") if n in grads]:
        err = np.abs(grads[name] - ref)
        res[name] = {"rel_l2": float(np.linalg.norm(grads[name] - ref)
                                     / np.linalg.norm(ref)),
                     "max_abs": float(err.max()),
                     "p99_abs": float(np.quantile(err, 0.99))}
    if jax32:
        res["jax32_vs_port32_rel_l2"] = float(
            np.linalg.norm(grads["jax32"] - grads["port32"])
            / np.linalg.norm(ref))
    return res


def first_out(rounds):
    """The first round at which each quantity leaves its tolerance."""
    out = {}
    for key, bad in (("loss", lambda r: r["loss"] > 1),
                     ("weights", lambda r: r["weights"] > 1),
                     ("stats", lambda r: r["stats"] > 1),
                     ("kept", lambda r: r["kept"] < 0.99)):
        out[key] = next((r["round"] for r in rounds if bad(r)), None)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("leg", choices=sorted(LEGS))
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--epochs", type=float, default=None)
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--against", choices=("port", "jax8"), default="port")
    ap.add_argument("--port_spread", default="",
                    help="comma-separated perturbation seeds: the port "
                         "alone from JAX's weights, unperturbed and "
                         "perturbed by --eps")
    ap.add_argument("--eps", type=float, default=1e-6)
    ap.add_argument("--grad_check", action="store_true",
                    help="only the first round's gradient against float64")
    ap.add_argument("--data_root", default=os.path.join(_REPO, "runs"))
    args = ap.parse_args(argv)
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    if args.grad_check or args.port_spread:
        res = (grad_check(args.leg, args.data_root, args.seed)
               if args.grad_check else
               port_spread(args.leg, args.data_root, args.eps,
                           [int(x) for x in args.port_spread.split(",")],
                           args.seed))
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
        print(json.dumps(res))
        return 0
    res = trace(args.leg, args.data_root, args.seed, args.epochs,
                args.rounds, args.against)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res["first_out"]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
