"""The port's drivers, each run with ``python -m``: ``serve`` (the
serving replica), ``supervise`` (the crash and hang restart ladder),
``orchestrate`` (the fleet of tenants) and ``crash_matrix`` (SIGKILL
and resume, checked bit for bit)."""
