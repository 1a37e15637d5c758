"""Device mesh and sharding: the parallel layer.

PyTorch counterpart of `lanpaint_tpu/parallel/mesh.py`.  A mesh has the
four named axes of the JAX package, (data, seq, tensor, expert), as a
`torch.distributed` DeviceMesh over the processes of one world (one
process a card; `torchrun` starts them, or `init_world` makes a world of
one).  Where JAX annotates shardings and lets XLA insert the collectives,
each rank here keeps its own part explicitly:

* "data": the latent batch.  `shard_batch` cuts a global tensor to this
  rank's rows; `with_data_parallel` runs a sampler on them and all-gathers
  the result, drawing every random tensor for the whole batch so that a
  seed gives the single-process output;
* "seq": the Wan frame axis, with ring attention over it
  (`parallel/ring.py`, `zoo.build_wan_seq_parallel`);
* "tensor": Megatron tensor parallelism of the Wan DiT (`models/wan.py`):
  `wan_tp_param_specs` cuts a full state dict into one tensor rank's
  shard, `wan_tp_rules` + `tp_plan_bytes` plan the bytes per device from a
  meta-device state dict, without weights;
* "expert": reserved, as in the JAX package.

Not ported (ROADMAP A.19b): applying the UNet, DiT, SD3, HiDream rules and
the layer-axis rules to running forwards (`shard_params_tp`,
`tp_param_shardings`), which JAX gets from GSPMD.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import shutil
import tempfile
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("data", "seq", "tensor", "expert")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    data: int = 1
    seq: int = 1
    tensor: int = 1
    expert: int = 1

    @property
    def total(self) -> int:
        return self.data * self.seq * self.tensor * self.expert


def world_size() -> int:
    """The processes of this world: the initialized group's size, else
    torchrun's WORLD_SIZE, else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


@contextlib.contextmanager
def init_world(device_type: str = "cuda"):
    """A context in which the default process group is initialized: from
    torchrun's environment when it set one, else a world of one over a file
    store in a fresh temporary directory.  NCCL for "cuda" (each rank on
    card LOCAL_RANK), gloo for "cpu"; a collective that waits 10 minutes
    raises.  On exit the group it made is destroyed and its store directory
    removed; a group that was already initialized is left as it is."""
    if dist.is_initialized():
        yield
        return
    backend = {"cuda": "nccl", "cpu": "gloo"}[device_type]
    timeout = datetime.timedelta(minutes=10)
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    directory = None
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, timeout=timeout)
    else:
        directory = tempfile.mkdtemp(prefix="lanpaint_world_")
        dist.init_process_group(backend, init_method=f"file://{directory}/store", rank=0,
                                world_size=1, timeout=timeout)
    try:
        yield
    finally:
        dist.destroy_process_group()
        if directory is not None:
            shutil.rmtree(directory, ignore_errors=True)


def make_mesh(spec: Optional[MeshSpec] = None, device_type: Optional[str] = None) -> DeviceMesh:
    """Build a (data, seq, tensor, expert) mesh over this world's processes
    on `device_type` ("cuda" unless the caller asks for "cpu"), in the
    initialized default group (`init_world`).  The default spec puts the
    whole world on "data"; a spec of another size raises ValueError."""
    n = world_size()
    if spec is None:
        spec = MeshSpec(data=n)
    if spec.total != n:
        raise ValueError(f"mesh spec {spec} needs {spec.total} devices, got {n}")
    shape = (spec.data, spec.seq, spec.tensor, spec.expert)
    return init_device_mesh(device_type or "cuda", shape, mesh_dim_names=AXES)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on: its card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's position along `axis` (the order of an all-gather over
    the axis's group)."""
    return dist.get_rank(mesh.get_group(axis))


def block(n: int, parts: int, index: int) -> slice:
    """Block `index` of `parts` equal blocks of range(n)."""
    size = n // parts
    return slice(index * size, (index + 1) * size)


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Concatenate every rank's `x` of `group` along `dim`, in group-rank
    order; a group of one returns x."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def shard_batch(mesh: DeviceMesh, x, batch_axis: int = 0) -> torch.Tensor:
    """This rank's rows of `x` along `batch_axis` (its block of the "data"
    axis) on the rank's device.  A batch that the axis does not divide is
    kept whole (replicated), as the JAX package leaves it unsharded."""
    x = torch.as_tensor(x)
    n = axis_size(mesh, "data")
    if x.shape[batch_axis] % n:
        return x.to(mesh_device(mesh))
    rows = block(x.shape[batch_axis], n, axis_index(mesh, "data"))
    return x.narrow(batch_axis, rows.start, rows.stop - rows.start).to(mesh_device(mesh))


def shard_params_replicated(mesh: DeviceMesh, params: dict) -> dict:
    """A state dict replicated on every rank: a copy onto the rank's device."""
    device = mesh_device(mesh)
    return {k: torch.as_tensor(v).to(device) for k, v in params.items()}


def batch_sharding(mesh: DeviceMesh, shape, batch_axis: int = 0) -> tuple:
    """The index of this rank's block of a tensor of `shape` sharded on
    `batch_axis` over "data": a tuple of slices."""
    index = [slice(None)] * len(shape)
    index[batch_axis] = block(shape[batch_axis], axis_size(mesh, "data"),
                              axis_index(mesh, "data"))
    return tuple(index)


def seq_sharding(mesh: DeviceMesh, shape, seq_axis: int) -> tuple:
    """The index of this rank's block of a tensor of `shape` with dim 0
    over "data" and `seq_axis` over "seq"."""
    index = list(batch_sharding(mesh, shape, 0))
    index[seq_axis] = block(shape[seq_axis], axis_size(mesh, "seq"), axis_index(mesh, "seq"))
    return tuple(index)


# --------------------------------------------------------------------------
# tensor parallelism of the Wan DiT


def _is_col(name: str) -> bool:
    return any(f"{a}.{w}.weight" in name for a in ("self_attn", "cross_attn") for w in "qkv") \
        or "ffn_0.weight" in name


def _is_row(name: str) -> bool:
    return any(f"{a}.o.weight" in name for a in ("self_attn", "cross_attn")) \
        or "ffn_2.weight" in name


def wan_tp_rules():
    """TP rules for the Wan DiT over the port's state-dict keys and
    nn.Linear layout (weight (out, in)): q/k/v and ffn_0 column-parallel
    (weight dim 0), o and ffn_2 row-parallel (weight dim 1); biases and norm
    scales replicated, as the JAX package's rules.  (predicate on the key,
    one mesh axis or None per dim.)"""
    return [(_is_col, ("tensor", None)), (_is_row, (None, "tensor"))]


def tp_plan_bytes(state_shapes, rules, axis_sizes: dict, dtype_bytes: int = 2) -> int:
    """Bytes per device under `rules`, from a state dict of shapes (a
    meta-device module's state_dict works: no weights are made).  The first
    matching rule wins; an axis that does not divide its dim leaves the dim
    whole; unmatched tensors count replicated.  `axis_sizes` maps axis
    names to sizes, e.g. {"tensor": 4}."""
    total = 0
    for name, t in state_shapes.items():
        shape = list(t.shape)
        for pred, spec in rules:
            if pred(name):
                for dim, axis in enumerate(spec):
                    div = axis_sizes.get(axis, 1) if axis is not None else 1
                    if shape[dim] % div == 0:
                        shape[dim] //= div
                break
        n = 1
        for s in shape:
            n *= int(s)
        total += n * dtype_bytes
    return total


def wan_tp_param_specs(state_dict: dict, rank: int, size: int) -> dict:
    """Tensor rank `rank`'s shard (of `size`) of a full Wan state dict, for
    `WanModel(cfg with tp_size=size)`: the column-parallel q/k/v and ffn_0
    weights and biases and the norm_q / norm_k scales cut on dim 0, the
    row-parallel o and ffn_2 weights on dim 1 (their biases, added once
    after the reduce, replicated), everything else whole.  The shards are
    views of `state_dict`'s tensors."""
    def cut(t, dim):
        part = block(t.shape[dim], size, rank)
        return t.narrow(dim, part.start, part.stop - part.start)

    out = {}
    for name, t in state_dict.items():
        col = _is_col(name) or any(f"{a}.{w}.bias" in name
                                   for a in ("self_attn", "cross_attn") for w in "qkv")
        col = col or "ffn_0.bias" in name or ".norm_q." in name or ".norm_k." in name
        if col:
            out[name] = cut(t, 0)
        elif _is_row(name):
            out[name] = cut(t, 1)
        else:
            out[name] = t
    return out


# --------------------------------------------------------------------------
# data parallelism


def _rows(tree, rows: slice, batch: int):
    """`tree` with every tensor whose leading dim is `batch` cut to `rows`."""
    if isinstance(tree, dict):
        return {k: _rows(v, rows, batch) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.ndim >= 1 and tree.shape[0] == batch:
        return tree[rows]
    return tree


def with_data_parallel(sampler_call, mesh: DeviceMesh):
    """Wrap a LanPaintSampler-style callable so that each "data" rank runs
    its rows of the batch and every rank returns the whole result.

    Called with global inputs (the same on every rank): `latent`, `noise`,
    a per-row `mask` (of the latent's rank), `noise_feed` (its batch dim 3)
    and the tensors of `cond` / `uncond` whose leading dim is the batch are
    cut to this rank's rows on its device; the sampler draws every random
    tensor for the whole batch and keeps these rows (`batch_rows`), so a
    seed gives the single-process output; the samples (dim 0) and the
    denoised history (dim 1) are all-gathered over "data".  A batch that
    "data" does not divide runs whole on every rank.  The think loop's
    semantic stop reads batch-wide statistics that a rank sees only for its
    rows, and on the card the fused think-step kernels key their normals by
    the element's index in the rank's own rows, so every rank would draw
    rank 0's noise: a sampler whose config turns on either is refused."""
    config = getattr(sampler_call, "config", None)
    if config is not None and config.semantic_stop_possible:
        raise ValueError("with_data_parallel: the semantic stop reads the whole batch; "
                         "a rank sees only its rows (set inner_threshold=0)")
    if config is not None and config.use_fused_kernels and mesh.device_type == "cuda":
        raise ValueError("with_data_parallel: the fused kernels draw the same normals on "
                         "every rank's rows (set use_fused_kernels=False)")
    group = mesh.get_group("data")
    n = axis_size(mesh, "data")
    device = mesh_device(mesh)

    def call(**kwargs):
        latent = torch.as_tensor(kwargs["latent"])
        b = latent.shape[0]
        if b % n:
            return sampler_call(**{k: (v.to(device) if isinstance(v, torch.Tensor) else v)
                                   for k, v in kwargs.items()})
        rows = block(b, n, axis_index(mesh, "data"))
        out = dict(kwargs, latent=latent[rows].to(device), batch_rows=(rows, b))
        if kwargs.get("noise") is not None:
            out["noise"] = torch.as_tensor(kwargs["noise"])[rows].to(device)
        mask = kwargs.get("mask")
        if mask is not None and torch.as_tensor(mask).ndim == latent.ndim:
            out["mask"] = torch.as_tensor(mask)[rows].to(device)
        if kwargs.get("noise_feed") is not None:
            out["noise_feed"] = torch.as_tensor(kwargs["noise_feed"])[:, :, :, rows]
        for key in ("cond", "uncond"):
            if kwargs.get(key) is not None:
                out[key] = _rows(kwargs[key], rows, b)
        result = sampler_call(**out)
        samples, history = result[0], result[1]
        return (all_gather(samples, group, 0), all_gather(history, group, 1)) + tuple(result[2:])

    return call
