"""The multi-GPU data plane of the port: one process per GPU, the round's
client slots split over the ranks of a ``ClientGroup``
(``parallel/mesh.py``). The collectives it runs live in
``ops/collectives.py``."""

from commefficient_torch.parallel.mesh import (
    ClientGroup,
    client_group_size,
    destroy_distributed,
    init_distributed,
    main_first,
    make_client_group,
    quiet_unless_main,
    start_client_group,
    world_from_env,
)

__all__ = ["ClientGroup", "client_group_size", "destroy_distributed",
           "init_distributed", "main_first", "make_client_group",
           "quiet_unless_main", "start_client_group", "world_from_env"]
