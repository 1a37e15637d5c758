"""The parallel layer: a (data, seq, tensor, expert) mesh of processes,
data parallelism, ring attention and the Wan tensor-parallel plan
(PyTorch counterpart of `lanpaint_tpu/parallel/`)."""

from .mesh import (  # noqa: F401
    MeshSpec,
    init_world,
    make_mesh,
    shard_batch,
    shard_params_replicated,
    tp_plan_bytes,
    wan_tp_param_specs,
    wan_tp_rules,
    with_data_parallel,
)
from .ring import ring_attention, seq_parallel_attention  # noqa: F401
