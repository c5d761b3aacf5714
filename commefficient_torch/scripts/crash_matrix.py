"""The port's crash matrix: SIGKILL ``cv_train`` at a seeded round,
resume, and compare the final weights bit for bit; a copy of the JAX
package's ``scripts/crash_matrix.py`` that imports nothing of it.

1. run ``python -m commefficient_torch.cv_train`` as a subprocess on the
   synthetic CIFAR split with ``--checkpoint_every_rounds`` and
   ``COMMEFFICIENT_HEARTBEAT=1`` (one flushed ``HEARTBEAT round=N`` line a
   drained round, N the global round index);
2. SIGKILL it when a seeded heartbeat round is reached: no cleanup,
   perhaps mid-save (the atomic rename in ``save_run_state`` makes that
   survivable);
3. rerun the same command with ``--resume auto`` to the end;
4. assert its final weights equal an uninterrupted run's bit for bit
   (``np.array_equal`` on every tensor of the saved checkpoint, read by
   ``commefficient_torch.federated.checkpoint.load_checkpoint``).

Legs (``--planes``): ``replicated``; ``shard`` (``--server_shard`` on a
client group of one rank, whose trajectory equals the replicated one);
``disk`` (the forced disk tier: after the kill the backing row files are
torn, and the resume must come from the checkpoint's CRC'd ``.rows``
snapshot; its own baseline); and ``supervise`` (opt-in: the child runs
under ``commefficient_torch.scripts.supervise``, and an external SIGKILL
and SIGSTOP each recover unattended to bit-identical weights, and a
disk-tier run with seeded silent row corruption completes with every
detection repaired or quarantined).

The children get ``--device cpu`` when asked (``--device cpu``), else
ask for the card; the JAX package's and XLA's variables are dropped from
their environment.

Usage::

    python -m commefficient_torch.scripts.crash_matrix [--trials N]
        [--seed S] [--workdir DIR] [--device cuda|cpu]
        [--planes replicated,shard,disk[,supervise]]
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

from commefficient_torch.profiling import parse_heartbeat

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# tiny synthetic split: 8 per class x 10 classes = 80 items, W=2 x B=4
# -> 10 rounds/epoch x 2 epochs; --checkpoint_every_rounds 3 means a kill
# anywhere loses at most 3 rounds of work
PER_CLASS = 8
ROUNDS_PER_EPOCH = 10
EPOCHS = 2


# the disk leg's forced placement: 1-byte budgets push the memory plan
# past the hbm and host tiers onto the MemmapRowStore (the
# tests/test_host_offload.py idiom)
DISK_ENV = {"COMMEFFICIENT_STATE_HBM_BUDGET": "1",
            "COMMEFFICIENT_STATE_HOST_BUDGET": "1"}


# the shard leg's process group of one rank (torchrun's environment; the
# port's --server_shard runs on a client group)
def shard_env() -> dict:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return {"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}


def child_env(extra: dict | None = None) -> dict:
    # the JAX package's and XLA's variables mean nothing to the port's
    # children, and a tenant's stray one must not leak into them
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "PALLAS_"))}
    env.update({
        "COMMEFFICIENT_TINY_MODEL": "1",
        "COMMEFFICIENT_SYNTHETIC_PER_CLASS": str(PER_CLASS),
        "COMMEFFICIENT_HEARTBEAT": "1",
        "HF_HUB_OFFLINE": "1",
        "TRANSFORMERS_OFFLINE": "1",
        "PYTHONPATH": _REPO + os.pathsep + env.get("PYTHONPATH", ""),
    })
    if extra:
        env.update(extra)
    return env


def train_argv(dataset_dir: str, ckpt_dir: str, shard: bool,
               disk: bool = False, device: str = "cuda") -> list:
    # the disk leg needs PER-CLIENT state for a row store to exist:
    # local error feedback (client-side momentum, so virtual momentum 0
    # per the ServerConfig contract); the direct-state legs keep the
    # original virtual-EF config
    error_type = "local" if disk else "virtual"
    lmom, vmom = ("0.9", "0") if disk else ("0", "0.9")
    argv = [
        sys.executable, "-m", "commefficient_torch.cv_train",
        "--device", device, "--dataset_name", "CIFAR10", "--dataset_dir", dataset_dir,
        "--num_epochs", str(EPOCHS), "--num_workers", "2",
        "--local_batch_size", "4", "--valid_batch_size", "8",
        "--iid", "--num_clients", "4",
        "--mode", "sketch", "--error_type", error_type,
        "--local_momentum", lmom, "--virtual_momentum", vmom,
        "--k", "200", "--num_cols", "1024", "--num_rows", "3",
        "--num_blocks", "2",
        "--lr_scale", "0.01", "--pivot_epoch", "0.5", "--seed", "0",
        "--train_dataloader_workers", "0",
        # drain_every 1 so each heartbeat lands the moment its round is
        # consumed — the kill point is then a true round boundary draw
        "--metrics_drain_every", "1",
        "--checkpoint", "--checkpoint_path", ckpt_dir,
        "--checkpoint_every_rounds", "3",
    ]
    if shard:
        # run with shard_env(): a client group of one rank
        argv += ["--server_shard"]
    if disk:
        argv += ["--state_dir", os.path.join(ckpt_dir, "state")]
    return argv


def tear_backing_file(state_dir: str) -> None:
    """Emulate the torn pwrite a SIGKILL mid-scatter can leave behind:
    flip bytes at the head of every backing row file. The resume must
    not read any of this — the fresh store truncates the files and
    ``restore_snapshot`` copies the checkpoint's CRC'd ``.rows``
    snapshot back — which is exactly what this drill pins."""
    for name in os.listdir(state_dir):
        if not name.endswith(".f32"):
            continue
        path = os.path.join(state_dir, name)
        with open(path, "r+b") as f:
            head = f.read(64)
            if not head:
                continue
            f.seek(0)
            f.write(bytes(b ^ 0xFF for b in head))  # guaranteed change
    print(f"[crash_matrix] tore backing files under {state_dir}")


def run_to_completion(argv, timeout=900, env_extra=None) -> None:
    proc = subprocess.run(argv, env=child_env(env_extra), cwd=_REPO,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"child failed rc={proc.returncode}:\n"
                           + proc.stdout[-3000:])


def run_and_kill(argv, kill_after_round: int, timeout=900,
                 env_extra=None) -> int:
    """Start the training child and SIGKILL it the moment its
    ``kill_after_round``-th round's heartbeat lands. The heartbeat is
    emitted by the round engine and carries the telemetry round index —
    the model's GLOBAL dispatch counter (0-based, monotonic across epochs,
    docs/observability.md) — so the supervisor parses the value directly
    instead of the old per-epoch line counting. Returns the 1-based count
    at the kill; the child may race a round further before the signal
    lands — that is the point, preemption is not polite."""
    proc = subprocess.Popen(argv, env=child_env(env_extra), cwd=_REPO,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    seen = 0
    killed = False
    deadline = time.monotonic() + timeout
    try:
        for line in proc.stderr:
            if time.monotonic() > deadline:
                break
            hb = parse_heartbeat(line)
            if hb is not None:
                seen = hb["round"] + 1
                if seen >= kill_after_round:
                    proc.send_signal(signal.SIGKILL)
                    killed = True
                    break
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    if not killed:
        raise RuntimeError(
            f"child finished after {seen} rounds, before the kill round "
            f"{kill_after_round} was reached — shrink the kill window")
    return seen


def final_weights(ckpt_dir: str):
    from commefficient_torch.federated.checkpoint import load_checkpoint

    params, model_state = load_checkpoint(os.path.join(ckpt_dir, "ResNet9"))
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, prefix + (str(k),))
        else:
            flat["/".join(prefix)] = np.asarray(node)

    walk(params, ("params",))
    walk(model_state, ("model_state",))
    return flat


def assert_identical(a: dict, b: dict, what: str) -> None:
    assert set(a) == set(b), (
        f"{what}: tensor sets differ: {set(a) ^ set(b)}")
    for key in sorted(a):
        np.testing.assert_array_equal(
            a[key], b[key], err_msg=f"{what}: {key} diverged")


def run_supervised(argv, events_path: str, kill_round=None,
                   kill_signal=None, timeout=1800, env_extra=None,
                   cwd=None):
    """Run the training child under the port's supervisor (the
    self-healing supervisor), optionally injecting one external fault:
    once attempt 1's heartbeat reaches ``kill_round``, send
    ``kill_signal`` to the CHILD pid (SIGKILL = crash; SIGSTOP = hang —
    heartbeats cease and the supervisor's deadline must fire). Returns
    ``(supervisor_rc, fault_sent)``. The supervisor's merged output is
    scanned for its ``[supervise] launch attempt=N pid(s)=[P]`` lines and the
    teed child heartbeats (profiling.parse_heartbeat — the shared
    format)."""
    sup_argv = [
        sys.executable, "-m", "commefficient_torch.scripts.supervise",
        "--heartbeat-timeout", "60", "--startup-grace", "600",
        "--max-restarts", "3", "--backoff", "1",
        "--events", events_path, "--",
    ] + argv
    proc = subprocess.Popen(sup_argv, env=child_env(env_extra),
                            cwd=cwd or _REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    child_pid = attempt = None
    sent = False
    deadline = time.monotonic() + timeout
    try:
        for line in proc.stdout:
            if time.monotonic() > deadline:
                proc.kill()
                break
            # the supervisor's line is "launch attempt=N pid(s)=[P, ...]"
            m = re.search(r"\[supervise\] launch attempt=(\d+) "
                          r"pid\(s\)=\[(\d+)", line)
            if m:
                attempt, child_pid = int(m.group(1)), int(m.group(2))
                continue
            hb = parse_heartbeat(line)
            if (hb is not None and not sent and kill_round is not None
                    and attempt == 1 and child_pid is not None
                    and hb["round"] + 1 >= kill_round):
                os.kill(child_pid, kill_signal)
                sent = True
                print(f"[crash_matrix] sent signal {int(kill_signal)} "
                      f"to supervised child {child_pid} at round "
                      f"{hb['round']}")
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    return rc, sent


def _count_events(path: str, kind: str) -> int:
    n = 0
    try:
        with open(path) as f:
            for line in f:
                try:
                    if json.loads(line).get("ev") == kind:
                        n += 1
                except json.JSONDecodeError:
                    pass
    except OSError:
        pass
    return n


def _newest_run_log(cwd: str) -> str:
    runs = sorted(os.path.join(cwd, "runs", d)
                  for d in os.listdir(os.path.join(cwd, "runs")))
    assert runs, f"no run dir under {cwd}"
    return os.path.join(runs[-1], "telemetry.jsonl")


def run_supervise_plane(workdir: str, data: str, want, rng,
                        trial: int, device: str = "cuda") -> None:
    """The supervisor leg (docs/fault_tolerance.md §self-healing
    supervisor): three unattended-recovery drills.

    1. **SIGKILL** (crash): the supervisor detects the child's death,
       relaunches with ``--resume auto``, and the final fp32 weights are
       BIT-identical to the uninterrupted baseline;
    2. **SIGSTOP** (hang): heartbeats cease without an exit — only the
       heartbeat deadline can see it; the supervisor SIGKILLs and
       resumes, same bit-identity bar;
    3. **silent row corruption**: a forced disk-tier run with seeded
       ``flip=P`` injection + checksums + scrub completes UNATTENDED,
       every detected corruption repaired or quarantined (counted in
       its telemetry JSONL — the trajectory legitimately differs when a
       quarantine drops an EF carry, so the bar here is detection +
       completion, not bitwise equality)."""
    total_rounds = EPOCHS * ROUNDS_PER_EPOCH
    kill_round = rng.randint(3, total_rounds - 3)
    for tag, sig in (("kill", signal.SIGKILL), ("hang", signal.SIGSTOP)):
        ckpt = os.path.join(workdir, f"supervise_{tag}_t{trial}")
        events = os.path.join(workdir, f"supervise_{tag}_t{trial}.jsonl")
        print(f"[crash_matrix] supervise/{tag} trial {trial}: "
              f"{'SIGKILL' if tag == 'kill' else 'SIGSTOP'} at round "
              f"{kill_round}")
        rc, sent = run_supervised(
            train_argv(data, ckpt, shard=False, device=device), events,
            kill_round=kill_round, kill_signal=sig)
        assert sent, (f"supervise/{tag}: child finished before the "
                      f"fault round {kill_round} — shrink the window")
        assert rc == 0, f"supervise/{tag}: supervisor exited rc={rc}"
        assert _count_events(events, "supervisor_launch") >= 2, \
            f"supervise/{tag}: no relaunch recorded"
        if tag == "hang":
            assert _count_events(events, "supervisor_timeout") >= 1, \
                "supervise/hang: the heartbeat deadline never fired"
        assert_identical(want, final_weights(ckpt),
                         f"supervise/{tag} trial {trial}")
        print(f"[crash_matrix] supervise/{tag}: recovered unattended, "
              f"fp32 trajectory bit-identical")
    # silent-corruption drill: flip injection + checksums + full-coverage
    # scrub on the forced disk tier, no external fault needed
    ckpt = os.path.join(workdir, f"supervise_flip_t{trial}")
    events = os.path.join(workdir, f"supervise_flip_t{trial}.jsonl")
    cwd = os.path.join(workdir, f"supervise_flip_cwd_t{trial}")
    os.makedirs(cwd, exist_ok=True)
    print(f"[crash_matrix] supervise/flip trial {trial}: seeded silent "
          f"corruption, checksums + scrub on")
    rc, _ = run_supervised(
        train_argv(data, ckpt, shard=False, disk=True, device=device)
        + ["--inject_io_fault", "flip=0.03,seed=5",
           "--io_scrub_rows", "8"],
        events, env_extra=DISK_ENV, cwd=cwd)
    assert rc == 0, f"supervise/flip: supervisor exited rc={rc}"
    log = _newest_run_log(cwd)
    corrupt = _count_events(log, "row_corrupt")
    repaired = _count_events(log, "row_repaired")
    quarantined = _count_events(log, "row_quarantined")
    assert corrupt > 0, \
        "supervise/flip: the seeded schedule injected nothing detected"
    assert corrupt == repaired + quarantined, (
        f"supervise/flip: {corrupt} detected corruptions but only "
        f"{repaired} repairs + {quarantined} quarantines")
    print(f"[crash_matrix] supervise/flip: completed unattended — "
          f"{corrupt} silent corruptions detected, {repaired} repaired, "
          f"{quarantined} quarantined")


def run_matrix(workdir: str, trials: int = 1, seed: int = 0,
               planes=("replicated", "shard", "disk"),
               device: str = "cuda") -> None:
    rng = random.Random(seed)
    data = os.path.join(workdir, "data")
    base_ckpt = os.path.join(workdir, "baseline")

    want = want_disk = None
    if any(p != "disk" for p in planes):
        print(f"[crash_matrix] baseline run ({EPOCHS} epochs x "
              f"{ROUNDS_PER_EPOCH} rounds)")
        run_to_completion(train_argv(data, base_ckpt, shard=False,
                                     device=device))
        want = final_weights(base_ckpt)
    if "disk" in planes:
        # the disk tier's trajectory is near-exact but not bitwise vs the
        # direct-state planes (delta-roundtrip caveat) — its own baseline
        disk_base = os.path.join(workdir, "baseline_disk")
        print("[crash_matrix] disk-tier baseline run")
        run_to_completion(train_argv(data, disk_base, shard=False,
                                     disk=True, device=device),
                          env_extra=DISK_ENV)
        want_disk = final_weights(disk_base)

    total_rounds = EPOCHS * ROUNDS_PER_EPOCH
    for plane in planes:
        if plane == "supervise":
            # the self-healing-supervisor leg: SIGKILL / injected hang /
            # injected silent corruption, all recovered UNATTENDED
            # (docs/fault_tolerance.md §self-healing supervisor)
            for trial in range(trials):
                run_supervise_plane(workdir, data, want, rng, trial,
                                    device=device)
            continue
        shard = plane == "shard"
        disk = plane == "disk"
        env_extra = DISK_ENV if disk else (shard_env() if shard else None)
        for trial in range(trials):
            # randomized mid-epoch kill point, away from the very last
            # rounds so the resume leg has real work left to replay
            kill_round = rng.randint(2, total_rounds - 3)
            ckpt = os.path.join(workdir, f"{plane}_t{trial}")
            argv = train_argv(data, ckpt, shard=shard, disk=disk,
                              device=device)
            print(f"[crash_matrix] {plane} trial {trial}: SIGKILL at "
                  f"round {kill_round}")
            killed_at = run_and_kill(argv, kill_round,
                                     env_extra=env_extra)
            if disk:
                # the storage half of the drill: a kill mid-scatter can
                # leave a half-landed pwrite — make it CERTAIN by tearing
                # the backing files; recovery must come from the CRC'd
                # .rows snapshot, never these bytes
                tear_backing_file(os.path.join(ckpt, "state"))
            print(f"[crash_matrix] killed at round {killed_at}; resuming "
                  f"with --resume auto")
            run_to_completion(argv + ["--resume", "auto"],
                              env_extra=env_extra)
            assert_identical(want_disk if disk else want,
                             final_weights(ckpt),
                             f"{plane} trial {trial} (killed at round "
                             f"{killed_at})")
            print(f"[crash_matrix] {plane} trial {trial}: fp32 trajectory "
                  f"bit-identical to the uninterrupted run")
    print("[crash_matrix] PASS")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trials", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--planes", default="replicated,shard,disk")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the children's --device (the card unless cpu)")
    args = ap.parse_args(argv)
    planes = tuple(p for p in args.planes.split(",") if p)
    workdir = args.workdir or tempfile.mkdtemp(prefix="crash_matrix_")
    print(f"[crash_matrix] workdir {workdir}")
    run_matrix(workdir, trials=args.trials, seed=args.seed, planes=planes,
               device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
