"""The federated round on PyTorch: configs, the round steps, the
FedModel / FedOptimizer / LambdaLR call surface, the pipelined round
engine, the health verdict (``round_health``), and the checkpoint and run
state (``checkpoint``). The observability plane is
``commefficient_torch.telemetry``."""

from commefficient_torch.federated.aggregator import (
    FedModel,
    FedOptimizer,
    LambdaLR,
)
from commefficient_torch.federated.engine import (
    PipelinedRoundEngine,
    cohort_lookahead,
)
from commefficient_torch.federated.rounds import RoundConfig, build_round_step
from commefficient_torch.federated.server import (
    ServerConfig,
    ServerState,
    init_server_state,
    round_health,
    server_update,
)
from commefficient_torch.federated.worker import WorkerConfig

__all__ = ["FedModel", "FedOptimizer", "LambdaLR", "PipelinedRoundEngine",
           "cohort_lookahead", "RoundConfig",
           "build_round_step", "ServerConfig", "ServerState",
           "init_server_state", "round_health", "server_update",
           "WorkerConfig"]
