"""Device ms a round of the rows launched under ``fed_client_phase`` (the
client phase: ``federated/rounds.py`` ``client_step`` and the model)."""


def read(ctx):
    cap = ctx.capture
    us = sum(o.us for o in cap.ops if "fed_client_phase" in o.spans)
    return us / 1e3 / cap.rounds if cap.ops else None
