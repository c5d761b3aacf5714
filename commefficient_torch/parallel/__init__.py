"""The multi-GPU data plane of the port: one process per GPU, the round's
client slots split over the ranks of a ``ClientGroup``, the 1-D clients
plane or the 2-D (clients x shard) grid (``parallel/mesh.py``), and
GPT-2's sequence parallelism over a ``seq`` axis of ranks: ring attention
(``parallel/ring.py``) and Ulysses all-to-all attention
(``parallel/ulysses.py``), its tensor parallelism over a ``model`` axis
(``models/gpt2.TPDense``), the mixture-of-experts MLP with its experts
over an ``expert`` axis (``parallel/moe.py``) and its GPipe pipeline over
a ``stage`` axis (``parallel/pipeline.py``). The collectives the data
plane runs live in ``ops/collectives.py``."""

from commefficient_torch.parallel.mesh import (
    CLIENTS_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
    SHARD_AXIS,
    STAGE_AXIS,
    ClientGroup,
    World,
    client_group_size,
    destroy_distributed,
    grid_axes,
    grid_shape,
    grid_sizes,
    init_distributed,
    main_first,
    make_client_group,
    mesh_axis_placement,
    quiet_unless_main,
    requested_axes,
    requested_seq_devices,
    start_client_group,
    tuple_index,
    world_from_env,
)
from commefficient_torch.parallel.moe import MoEMLP, ep_sliced_param
from commefficient_torch.parallel.ring import ring_attention
from commefficient_torch.parallel.ulysses import ulysses_attention


def __getattr__(name):
    # the pipeline imports the losses, which import the model, which
    # imports this package: loaded on first use
    if name in ("make_gpt2_pp_losses", "pp_layer_ranges"):
        from commefficient_torch.parallel import pipeline

        return getattr(pipeline, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["CLIENTS_AXIS", "EXPERT_AXIS", "MODEL_AXIS", "SEQ_AXIS",
           "SHARD_AXIS", "STAGE_AXIS", "ClientGroup", "MoEMLP", "World",
           "client_group_size", "destroy_distributed", "ep_sliced_param",
           "grid_axes", "grid_shape", "grid_sizes", "init_distributed",
           "main_first", "make_client_group", "make_gpt2_pp_losses",
           "mesh_axis_placement", "pp_layer_ranges", "quiet_unless_main",
           "requested_axes", "requested_seq_devices", "ring_attention",
           "start_client_group", "tuple_index", "ulysses_attention",
           "world_from_env"]
