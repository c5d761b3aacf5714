"""Device ms a round of the rows launched inside ``fed_round`` but outside
the client and server phases: ``FedModel.begin_round``'s byte accounting
and batch staging, the seal and the engine's own work."""


def read(ctx):
    cap = ctx.capture
    us = sum(o.us for o in cap.ops if "fed_round" in o.spans
             and not o.spans & {"fed_client_phase", "fed_server_phase"})
    return us / 1e3 / cap.rounds if cap.ops else None
