"""The parallel layer: a (data, seq, tensor, expert) mesh of processes,
data parallelism, ring attention, and the tensor, expert and layer-axis
sharding rules of the UNet, MMDiT, SD3, HiDream and Wan families
(PyTorch counterpart of `lanpaint_tpu/parallel/`)."""

from .mesh import (  # noqa: F401
    Cut,
    MeshSpec,
    Spec,
    dit_tp_rules,
    hidream_ep_rules,
    init_world,
    layer_shard_rules,
    make_mesh,
    mesh_device,
    plan_mesh,
    sd3_tp_rules,
    shard_batch,
    shard_params_replicated,
    shard_params_tp,
    tp_param_shardings,
    tp_plan_bytes,
    unet_tp_rules,
    wan_tp_param_specs,
    wan_tp_rules,
    with_data_parallel,
)
from .ring import ring_attention, seq_parallel_attention  # noqa: F401
