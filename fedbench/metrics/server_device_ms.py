"""Device ms a round of the rows launched under ``fed_server_phase`` (the
server phase: ``federated/server.py``, ``rounds.py`` ``server_step`` and
the telemetry vector inside it)."""


def read(ctx):
    cap = ctx.capture
    us = sum(o.us for o in cap.ops if "fed_server_phase" in o.spans)
    return us / 1e3 / cap.rounds if cap.ops else None
