"""The serving replica: the port of ``commefficient_tpu/federated/
serving.py``, which answers requests from a training run's newest
checkpoint while the run goes on.

- ``SnapshotTracker`` follows the run through its run-state checkpoints
  by snapshot handoff: it polls the checkpoint directory, validates the
  newest candidate by its content checksum (the discovery of ``--resume
  auto``) and loads the flat ``ps_weights`` only, never the client rows.
  The checkpoint's ``rounds_dispatched`` is the published
  ``model_version``; discovery orders candidates by training progress,
  so versions are monotone.
- The tracker pins what it reads: a ``<owner>.pin`` JSON lease in the
  checkpoint directory, written atomically before the candidate is
  opened, covering the served and the candidate file during a swap and
  removed on close. ``checkpoint.prune_run_states`` never deletes a
  pinned file.
- ``ServingReplica`` answers requests over a file queue: a client drops
  ``<serve_dir>/requests/<id>.json`` (atomic rename), the replica writes
  ``<serve_dir>/responses/<id>.json`` with the served ``model_version``
  and the latency, and appends ``serving_*`` events to
  ``serving.jsonl`` in the telemetry log's record shape (``python -m
  commefficient_torch.scripts.obs_report`` renders it). With
  ``COMMEFFICIENT_HEARTBEAT=1`` each iteration prints ``HEARTBEAT
  round=<served version> serve_lag=<versions behind>``.

Ops: ``ping``, ``stat`` (norm, dim, CRC of the weights), ``query`` (the
weights projected on a seeded unit vector: an answer that changes with
every swap) and ``eval`` (an injected ``predict_fn(weights, inputs)``;
unwired, as in the JAX package). The replica is host numpy, as the JAX
package's is: it runs nothing on a device and never initializes CUDA,
so it takes no context or memory from a trainer on the same card.
"""

from __future__ import annotations

import json
import os
import time
import uuid
import zlib
from typing import Any, Callable, Dict, Optional

import numpy as np

__all__ = ["ServingReplica", "SnapshotTracker", "read_response",
           "submit_request"]


class SnapshotTracker:
    """Follow a training run's run-state checkpoints, weights-only, with
    a pin/lease protecting every file the replica reads or serves from
    ``prune_run_states`` (docs/service.md §snapshot handoff)."""

    def __init__(self, checkpoint_path: str, owner: Optional[str] = None):
        self.checkpoint_path = checkpoint_path
        self.owner = owner or f"serve_{os.getpid()}"
        self.path: Optional[str] = None
        self.version = -1
        self.weights: Optional[np.ndarray] = None
        self.meta: Optional[dict] = None
        self.swaps = 0
        self._pin_file = os.path.join(checkpoint_path,
                                      f"{self.owner}.pin")

    # -- pin/lease ---------------------------------------------------------

    def _write_pin(self, paths) -> None:
        """Atomically (re)write the lease. ``paths`` may be empty — an
        empty lease pins nothing but keeps the owner visible."""
        os.makedirs(self.checkpoint_path, exist_ok=True)
        tmp = self._pin_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"owner": self.owner, "pid": os.getpid(),
                       "paths": [os.path.basename(p) for p in paths],
                       "t": time.time()}, f)
        os.replace(tmp, self._pin_file)

    def release(self) -> None:
        """Drop the lease (replica shutdown) — the pruner may GC
        everything again."""
        try:
            os.remove(self._pin_file)
        except OSError:
            pass

    # -- discovery / hot swap ----------------------------------------------

    def poll(self) -> bool:
        """One discovery pass: pin + validate + load the newest
        checkpoint if it is newer than what is being served. Returns
        True on a hot swap. The pin lands BEFORE the candidate is
        opened and covers the old file until the swap commits, so
        neither side of a handoff can be pruned mid-read."""
        from commefficient_torch.federated.checkpoint import (
            _read_npz,
            _run_state_files,
            _verify_checksum,
        )

        for cand in _run_state_files(self.checkpoint_path):
            if self.path is not None and \
                    os.path.abspath(cand) == os.path.abspath(self.path):
                return False  # newest valid candidate is already served
            self._write_pin([p for p in (self.path, cand)
                             if p is not None])
            try:
                flat = _read_npz(cand)
                meta = json.loads(bytes(flat.pop("meta_json")).decode())
                _verify_checksum(flat, meta, cand)
            except Exception as e:  # torn candidate: fall back to older
                print(f"serving: skipping {cand}: {e}", flush=True)
                continue
            version = int(meta.get("rounds_dispatched", 0))
            if version < self.version:
                # progress-ordered discovery found nothing newer; keep
                # serving what we have (re-pin it alone)
                self._write_pin([self.path] if self.path else [])
                return False
            self.weights = np.asarray(flat["ps_weights"])
            self.path, self.version, self.meta = cand, version, meta
            self.swaps += 1
            self._write_pin([cand])
            return True
        return False

    def lag(self) -> int:
        """Checkpoints strictly newer (by training progress) than the
        one being served — the heartbeat's ``serve_lag`` field. 0 when
        current; grows while the replica is wedged or mid-validation."""
        from commefficient_torch.federated.checkpoint import _run_state_files

        if self.path is None:
            return 0
        served = os.path.abspath(self.path)
        n = 0
        for cand in _run_state_files(self.checkpoint_path):
            if os.path.abspath(cand) == served:
                break
            n += 1
        return n


class ServingReplica:
    """The serving loop: hot-swap polling + a file-based request queue
    (module docstring; docs/service.md §serving)."""

    def __init__(self, checkpoint_path: str, serve_dir: str,
                 owner: Optional[str] = None,
                 predict_fn: Optional[Callable[..., Any]] = None,
                 log_path: Optional[str] = None):
        self.tracker = SnapshotTracker(checkpoint_path, owner)
        self.serve_dir = serve_dir
        self.req_dir = os.path.join(serve_dir, "requests")
        self.resp_dir = os.path.join(serve_dir, "responses")
        os.makedirs(self.req_dir, exist_ok=True)
        os.makedirs(self.resp_dir, exist_ok=True)
        self.predict_fn = predict_fn
        self.answered = 0
        self.errors = 0
        self._log = open(log_path
                         or os.path.join(serve_dir, "serving.jsonl"), "a")
        from commefficient_torch.profiling import Heartbeat

        self.heartbeat = Heartbeat()
        self._event("serving_start", checkpoint_path=checkpoint_path,
                    serve_dir=serve_dir, owner=self.tracker.owner)

    def _event(self, ev: str, **fields) -> None:
        # same flushed-JSONL record shape as telemetry.RunTelemetry.event
        # — obs_report's Serving section reads serving.jsonl directly
        rec: Dict[str, Any] = {"ev": ev, "t": time.time()}
        rec.update(fields)
        self._log.write(json.dumps(rec) + "\n")
        self._log.flush()

    # -- request handling --------------------------------------------------

    def _answer(self, req: dict) -> dict:
        w = self.tracker.weights
        op = req.get("op", "ping")
        out: Dict[str, Any] = {"op": op,
                               "model_version": self.tracker.version}
        if w is None:
            out["error"] = "no model snapshot available yet"
            return out
        if op == "ping":
            pass
        elif op == "stat":
            wc = np.ascontiguousarray(w)
            out.update(dim=int(w.size),
                       norm=float(np.linalg.norm(w)),
                       crc=int(zlib.crc32(wc.tobytes())))
        elif op == "query":
            # deterministic weights-dependent probe: project onto a
            # seeded unit vector — the same seed against two model
            # versions gives two different answers, which is exactly the
            # monotone-version witness the e2e test needs
            seed = int(req.get("probe_seed", 0))
            rng = np.random.RandomState(seed)
            v = rng.standard_normal(w.size).astype(np.float32)
            out["value"] = float(np.asarray(w, np.float32)
                                 @ (v / np.linalg.norm(v)))
        elif op == "eval":
            if self.predict_fn is None:
                out["error"] = ("this replica has no predict_fn wired "
                                "(commefficient_torch.scripts.serve)")
            else:
                out["outputs"] = self.predict_fn(w, req.get("inputs"))
        else:
            out["error"] = f"unknown op {op!r}"
        return out

    def step(self) -> int:
        """One service iteration: hot-swap poll, then drain every
        readable request. Returns the number of requests answered."""
        t0 = time.time()
        if self.tracker.poll():
            self._event("serving_swap",
                        path=os.path.basename(self.tracker.path),
                        model_version=self.tracker.version,
                        load_ms=round((time.time() - t0) * 1e3, 3))
        served = 0
        for name in sorted(os.listdir(self.req_dir)):
            if not name.endswith(".json"):
                continue  # .tmp mid-rename from a concurrent submitter
            fn = os.path.join(self.req_dir, name)
            try:
                with open(fn) as f:
                    req = json.load(f)
            except (OSError, ValueError):
                continue  # torn/vanished — retry next pass
            t1 = time.time()
            resp = self._answer(req)
            resp["latency_ms"] = round((time.time() - t1) * 1e3, 3)
            rid = str(req.get("id", os.path.splitext(name)[0]))
            resp["id"] = rid
            tmp = os.path.join(self.resp_dir, rid + ".tmp")
            with open(tmp, "w") as f:
                json.dump(resp, f)
            os.replace(tmp, os.path.join(self.resp_dir, rid + ".json"))
            try:
                os.remove(fn)
            except OSError:
                pass
            served += 1
            self.answered += 1
            if "error" in resp:
                self.errors += 1
            self._event("serving_answer", op=resp["op"], id=rid,
                        model_version=resp["model_version"],
                        latency_ms=resp["latency_ms"],
                        **({"error": resp["error"]} if "error" in resp
                           else {}))
        if self.heartbeat.enabled:
            # round = the SERVED model version; a wedged replica beats
            # with a growing serve_lag instead of going silent
            self.heartbeat.round(max(self.tracker.version, 0),
                                 serve_lag=self.tracker.lag())
        return served

    def serve_forever(self, poll_interval: float = 0.5,
                      max_requests: Optional[int] = None,
                      deadline_s: Optional[float] = None,
                      stop_file: Optional[str] = None) -> None:
        """Serve until ``max_requests`` answered, ``deadline_s`` elapsed,
        or ``stop_file`` appears (the test/bench harness's clean-stop
        seam); always releases the pin lease on the way out."""
        end = time.time() + deadline_s if deadline_s else None
        try:
            while True:
                served = self.step()
                if max_requests is not None \
                        and self.answered >= max_requests:
                    break
                if end is not None and time.time() > end:
                    break
                if stop_file is not None and os.path.exists(stop_file):
                    break
                if served == 0:
                    time.sleep(poll_interval)
        finally:
            self.close()

    def close(self) -> None:
        if self._log.closed:
            return
        self._event("serving_stop", answered=self.answered,
                    errors=self.errors, swaps=self.tracker.swaps,
                    model_version=self.tracker.version)
        self.tracker.release()
        self._log.close()


# -- client helpers (tests, bench, and ad-hoc curl-alikes) -----------------


def submit_request(serve_dir: str, op: str = "ping", **fields) -> str:
    """Drop one request into the queue (atomic rename — the replica
    never sees a half-written file). Returns the request id to pass to
    ``read_response``."""
    rid = uuid.uuid4().hex[:12]
    req: Dict[str, Any] = {"op": op, "id": rid}
    req.update(fields)
    rdir = os.path.join(serve_dir, "requests")
    os.makedirs(rdir, exist_ok=True)
    tmp = os.path.join(rdir, rid + ".tmp")
    with open(tmp, "w") as f:
        json.dump(req, f)
    os.replace(tmp, os.path.join(rdir, rid + ".json"))
    return rid


def read_response(serve_dir: str, rid: str, timeout: float = 30.0,
                  poll: float = 0.05) -> dict:
    """Block until the replica answers request ``rid`` (bounded)."""
    fn = os.path.join(serve_dir, "responses", rid + ".json")
    end = time.time() + timeout
    while time.time() < end:
        if os.path.exists(fn):
            with open(fn) as f:
                return json.load(f)
        time.sleep(poll)
    raise TimeoutError(f"no response for request {rid} within {timeout}s")
