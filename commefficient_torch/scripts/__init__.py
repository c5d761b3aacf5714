"""The port's drivers and tools, each run with ``python -m``: ``serve`` (the
serving replica), ``supervise`` (the crash and hang restart ladder),
``orchestrate`` (the fleet of tenants), ``crash_matrix`` (SIGKILL and
resume, checked bit for bit), ``obs_report`` (the run report of a
telemetry, fleet, serving or supervisor log), and the learning evidence
``sketch_fidelity``, ``learning_fullscale``, ``learning_midscale``,
``learning_async``, ``femnist_ablation`` and ``gpt2_golden_calibrate``
(their shared flags and records in ``evidence``), ``host_offload_fullscale``
(the EMNIST-scale client state in the host tier), ``multihost_demo`` (a
round across two "nodes" of ranks; its tiny geometries in
``tiny_rounds``) and ``native_bench`` (the host data plane)."""
