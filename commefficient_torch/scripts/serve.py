"""The port's serving replica for a training run: a copy of the JAX
package's ``scripts/serve.py`` with the same flags and lines, run as
``python -m commefficient_torch.scripts.serve``.

It follows the run's checkpoint directory by snapshot handoff, loads the
weights only, and answers requests over the file queue in
``--serve_dir``::

    python -m commefficient_torch.scripts.serve \\
        --checkpoint_path ckpt/ --serve_dir serve/ &
    python -m commefficient_torch.scripts.serve --serve_dir serve/ \\
        --request stat   # client

Every answer carries ``model_version``, the run's global round counter
at the served checkpoint, monotone across swaps. ``HEARTBEAT
round=<version> serve_lag=<behind>`` lines (on by default here) let the
supervisor watch the replica; ``serving_*`` events land in
``<serve_dir>/serving.jsonl``. The replica pins the checkpoint it serves
with a ``.pin`` lease, which ``prune_run_states`` respects. It is host
numpy: it never initializes CUDA.
"""

import argparse
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint_path", default="",
                    help="Training run's checkpoint dir to track "
                         "(server mode).")
    ap.add_argument("--serve_dir", required=True,
                    help="Queue dir: requests/, responses/, "
                         "serving.jsonl.")
    ap.add_argument("--owner", default="",
                    help="Pin-lease owner name (default serve_<pid>).")
    ap.add_argument("--poll_interval", type=float, default=0.5,
                    help="Idle sleep between service iterations (s).")
    ap.add_argument("--max_requests", type=int, default=0,
                    help="Stop after answering N requests (0 = no cap).")
    ap.add_argument("--deadline_s", type=float, default=0.0,
                    help="Stop after this many seconds (0 = no cap).")
    ap.add_argument("--stop_file", default="",
                    help="Stop when this file appears (harness seam).")
    ap.add_argument("--no_heartbeat", action="store_true",
                    help="Suppress the HEARTBEAT stderr lines.")
    ap.add_argument("--request", default="",
                    help="CLIENT mode: submit one request of this op "
                         "(ping|stat|query), print the JSON response.")
    ap.add_argument("--probe_seed", type=int, default=0,
                    help="Client mode: the query op's probe seed.")
    ap.add_argument("--timeout", type=float, default=30.0,
                    help="Client mode: response wait bound (s).")
    args = ap.parse_args()

    if args.request:
        from commefficient_torch.federated.serving import (
            read_response,
            submit_request,
        )

        rid = submit_request(args.serve_dir, op=args.request,
                             probe_seed=args.probe_seed)
        resp = read_response(args.serve_dir, rid, timeout=args.timeout)
        print(json.dumps(resp))
        return 1 if "error" in resp else 0

    assert args.checkpoint_path, (
        "server mode needs --checkpoint_path (or pass --request for "
        "client mode)")
    if not args.no_heartbeat:
        # liveness on by default: a serving replica exists to be watched
        os.environ.setdefault("COMMEFFICIENT_HEARTBEAT", "1")
    from commefficient_torch.federated.serving import ServingReplica

    replica = ServingReplica(args.checkpoint_path, args.serve_dir,
                             owner=args.owner or None)
    try:
        replica.serve_forever(
            poll_interval=args.poll_interval,
            max_requests=args.max_requests or None,
            deadline_s=args.deadline_s or None,
            stop_file=args.stop_file or None)
    except KeyboardInterrupt:
        replica.close()
    print(f"serving done: answered={replica.answered} "
          f"errors={replica.errors} swaps={replica.tracker.swaps} "
          f"final_version={replica.tracker.version}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
