"""Data- and tensor-parallel runtime — counterpart of
``audiogpt_tpu/parallel`` over ``torch.distributed`` (torchrun, NCCL on the
card, gloo on the CPU), with the port-only collectives of
``parallel/reduce.py`` that keep a loss's global-batch semantics; and the
serving engines' one-process mesh of cards (``device_mesh``)."""

from audiogpt_tpu_torch.parallel.mesh import (  # noqa: F401
    LocalMesh,
    MeshSpec,
    ReplicaMesh,
    bind_data_axis,
    device_mesh,
    distributed_init,
    is_main,
    local_batch_slice,
    make_mesh,
    param_sharding,
    replicate,
    shard_batch,
)
from audiogpt_tpu_torch.parallel.reduce import (  # noqa: F401
    gather_rows,
    global_l2,
    global_mean,
    global_means,
    global_rows,
    global_sum,
    global_sums,
    local_rows,
    world,
)
from audiogpt_tpu_torch.parallel.tp_rules import (  # noqa: F401
    apply_tp,
    tp_rules,
)
