"""Distribution of the port's training and serving over processes: the
mesh and its sharding rules, the served shards and the gather of a served
batch (``mesh``), cross-process metric reduction (``reduce``) and
the GPipe schedule (``pipeline``, imported from its module: it builds on
models/gpt.py)."""

from .mesh import (  # noqa: F401
    AXES,
    DATA_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    Mesh,
    as_mesh,
    broadcast_object,
    data_coordinate,
    data_size,
    gather_rows,
    gather_tree,
    head_counts,
    head_range,
    is_primary,
    local_batch_slice,
    make_mesh,
    maybe_init_distributed,
    parse_mesh,
    process_count,
    process_index,
    shard_block_weight,
    shard_block_weights,
    shard_gpt_for_serving,
    shard_tree,
    shutdown_distributed,
)
