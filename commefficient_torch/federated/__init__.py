"""The federated round on PyTorch: configs, the round steps, and the
FedModel / FedOptimizer / LambdaLR call surface."""

from commefficient_torch.federated.aggregator import (
    FedModel,
    FedOptimizer,
    LambdaLR,
)
from commefficient_torch.federated.rounds import RoundConfig, build_round_step
from commefficient_torch.federated.server import (
    ServerConfig,
    ServerState,
    init_server_state,
    server_update,
)
from commefficient_torch.federated.worker import WorkerConfig

__all__ = ["FedModel", "FedOptimizer", "LambdaLR", "RoundConfig",
           "build_round_step", "ServerConfig", "ServerState",
           "init_server_state", "server_update", "WorkerConfig"]
