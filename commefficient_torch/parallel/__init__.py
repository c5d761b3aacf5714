"""The multi-GPU data plane of the port: one process per GPU, the round's
client slots split over the ranks of a ``ClientGroup``, the 1-D clients
plane or the 2-D (clients x shard) grid (``parallel/mesh.py``). The
collectives it runs live in ``ops/collectives.py``."""

from commefficient_torch.parallel.mesh import (
    CLIENTS_AXIS,
    SHARD_AXIS,
    ClientGroup,
    World,
    client_group_size,
    destroy_distributed,
    grid_shape,
    init_distributed,
    main_first,
    make_client_group,
    mesh_axis_placement,
    quiet_unless_main,
    start_client_group,
    tuple_index,
    world_from_env,
)

__all__ = ["CLIENTS_AXIS", "SHARD_AXIS", "ClientGroup", "World",
           "client_group_size", "destroy_distributed", "grid_shape",
           "init_distributed", "main_first", "make_client_group",
           "mesh_axis_placement", "quiet_unless_main", "start_client_group",
           "tuple_index", "world_from_env"]
