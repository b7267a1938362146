"""Distributed execution of the port over ``torch.distributed`` (the JAX
package's ``parallel/``): the data mesh and process group (``mesh``),
the step's collectives (``collectives``: the data group, the tp group's
Megatron pairs, the sp group's ring, all-to-all and broadcast, the
pipeline group's sends and receives), the
sharding rules (``sharding``: the data axes, tp and pp residency), the
fused FFN's tp tile (``kernel_shard``), the pipeline's rule table and
executor (``pipeline``) and the state's placement (``placement``).  One
process a rank, NCCL on the card and gloo on the CPU."""

from faster_distributed_training_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_ALIASES,
    MeshSpec,
    axis_size,
    canonical_axes,
    canonical_axis,
    initialize_distributed,
    local_batch_slice,
    local_device,
    make_mesh,
    mesh_groups,
    parse_mesh,
    pp_size,
    seq_parallel_axis,
    sp_size,
    tp_size,
)
from faster_distributed_training_tpu_torch.parallel.sharding import (  # noqa: F401
    bucketed_grad_reduce,
    apply_tp_rules,
    classify_opt_state_leaf,
    fsdp_partition_params,
    offload_opt_leaf,
    tensor_parallel_rules,
    tp_cut,
    zero1_opt_specs,
    zero_opt_dims,
)
from faster_distributed_training_tpu_torch.parallel.placement import (  # noqa: F401
    Placement,
    data_axes,
    dp_size,
    make_put_batch,
    shard_train_state,
    train_state_shardings,
)
from faster_distributed_training_tpu_torch.parallel.collectives import (  # noqa: F401
    DataGroup,
    PipeGroup,
    SequenceGroup,
    TensorGroup,
    all_gather_across_processes,
    all_reduce_metrics,
    all_sum_across_processes,
)
