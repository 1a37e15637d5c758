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
* "tensor": Megatron tensor parallelism.  The rules of the JAX package
  (`wan_tp_rules`, `unet_tp_rules`, `dit_tp_rules`, `sd3_tp_rules`,
  `hidream_ep_rules`), written over the port's state_dict keys and
  nn.Linear layout, place each tensor; `tp_param_shardings` gives a
  rank's index of each, `shard_params_tp` cuts a full state dict into the
  rank's shard and `tp_plan_bytes` counts the bytes a rank holds, from a
  meta-device state dict.  Where GSPMD inserts collectives, the models
  (models/layers.py and the model modules) all-reduce and all-gather over
  the axis's group themselves;
* "expert": the HiDream MoE's routed experts (`hidream_ep_rules`), a
  rank holding its experts and the gate contraction all-reduced;
* a layer axis (`layer_shard_rules`, FSDP style): each block list
  depth-sharded, a block's owner broadcasting its weights before it runs.

The design is explicit process groups, not DTensor: the port's kernels
launch through ctypes and would each need a DTensor sharding rule, the
eager UNet path is host-bound already, and explicit shards are tested
tensor by tensor.  A fused projection is cut per part (q | k | v and the
like, `Cut.parts`), and a block's heads are split only where the axis
divides their count (`Cut.heads`): both give a rank a computable shard,
where GSPMD cuts in contiguous blocks and repairs what a cut crosses.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import datetime
import math
import os
import re
import shutil
import tempfile
from typing import NamedTuple, Optional

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
# sharding rules: the GSPMD half of the JAX package, made explicit
#
# A rule is (predicate on the state_dict key, Spec).  The first rule whose
# predicate holds places the tensor; a tensor no rule matches is replicated.
# Where JAX annotates a spec and GSPMD cuts each array in contiguous blocks
# and repairs whatever the cut crosses, a rank here computes on its own
# shard: a fused projection (q | k | v, k | v, GEGLU's a | gate, Flux's
# linear1 and linear2) is cut per part (`Cut.parts`), and a block's heads
# are split only where the axis divides its head count (`Cut.heads`),
# else the whole block stays on every rank.


class Axis(NamedTuple):
    """One mesh axis as this rank sees it: the axis's process group (None
    on a planned mesh, or for an axis the caller did not name), its size,
    and this rank's position along it."""

    group: object
    size: int
    index: int


NO_AXIS = Axis(None, 1, 0)


def plan_mesh(**axes) -> dict:
    """A planned mesh: {axis: (size, this rank's index)} for the axes named,
    the others of size 1.  It places nothing and runs no collective: the
    rule functions below and the models' constructors take it where they
    take a DeviceMesh, to lay out one rank's state on the meta device."""
    return {a: tuple(axes.get(a, (1, 0))) for a in AXES}


def axis_of(mesh, name: Optional[str]) -> Axis:
    """The Axis `name` of a DeviceMesh or a planned mesh; no mesh or no
    name is NO_AXIS."""
    if mesh is None or name is None:
        return NO_AXIS
    if isinstance(mesh, dict):
        return Axis(None, *mesh[name])
    return Axis(mesh.get_group(name), axis_size(mesh, name), axis_index(mesh, name))


def _sizes(mesh) -> dict:
    if isinstance(mesh, dict):
        return {a: size for a, (size, _) in mesh.items()}
    return {a: axis_size(mesh, a) for a in mesh.mesh_dim_names}


def _indices(mesh) -> dict:
    if isinstance(mesh, dict):
        return {a: index for a, (_, index) in mesh.items()}
    return {a: axis_index(mesh, a) for a in mesh.mesh_dim_names}


@dataclasses.dataclass(frozen=True)
class Cut:
    """One dim cut over a mesh axis.  `parts`: the dim's fused parts, an int
    (that many equal parts) or a function of the tensor's shape giving
    their sizes; each part is cut in `size` blocks and the rank keeps its
    block of every part, in order.  `heads`: the head count of the block
    the tensor belongs to (an int, or a function of the key): the dim stays
    whole unless the axis divides it, as a head is never split.  A dim the
    axis does not divide (in every part) stays whole, as JAX's
    `_divisible_spec` leaves it."""

    axis: str
    parts: object = 1
    heads: object = None


@dataclasses.dataclass(frozen=True)
class Spec:
    """Where a rule places a tensor.  `dims`: one entry a dim of the port's
    tensor (nn.Linear weights are (out, in)), None (whole), an axis name
    (a contiguous cut) or a `Cut`; `scanned`: JAX's spec carries a scanned
    stack's depth dim first, so it fits only a tensor of a block list;
    `layers`: the axis over which the tensor's block list is depth-sharded
    (`layer_shard_rules`)."""

    dims: tuple = ()
    scanned: bool = False
    layers: Optional[str] = None


# a key inside a block list (JAX's scanned stacks): the list and the index
_STACK = re.compile(r"^((?:\w+\.)*?(?:blocks|double|single|joint_dual|joint))\.(\d+)\.")


def stack_of(key: str):
    """(block list, block index) of a key inside a block list (the UNet's
    `<transformer>.blocks`, the MMDiT's and HiDream's `double` / `single`,
    SD3's `joint_dual` / `joint`, Wan's `blocks`), else None."""
    m = _STACK.match(key)
    return None if m is None else (m.group(1), int(m.group(2)))


def _part_sizes(parts, shape, dim) -> tuple:
    if callable(parts):
        return tuple(parts(shape))
    if shape[dim] % parts:
        raise ValueError(f"dim {dim} of {tuple(shape)} is not {parts} equal parts")
    return (shape[dim] // parts,) * parts


def _spec_of(key, rules) -> Optional[Spec]:
    for pred, spec in rules:
        if pred(key):
            return spec if isinstance(spec, Spec) else Spec(tuple(spec))
    return None


def _specs(state_shapes: dict, rules) -> dict:
    """Each key's Spec (None: replicated).  A spec for the scanned blocks'
    weights that matches a tensor outside the block lists raises
    ValueError naming every such tensor: JAX's spec is one dim longer than
    that array there."""
    specs = {k: _spec_of(k, rules) for k in state_shapes}
    bad = [f"{k} {tuple(state_shapes[k].shape)}" for k, s in specs.items()
           if s is not None and s.scanned and stack_of(k) is None]
    if bad:
        raise ValueError("rules for the scanned blocks' weights match tensors outside the block "
                         "lists (a spec one dim longer than the array in JAX): " + ", ".join(bad))
    return specs


def _cuts(key, shape, spec: Spec, sizes: dict) -> list:
    """Per dim of the tensor: None (whole) or (axis, the parts' sizes)."""
    if len(spec.dims) > len(shape):
        raise ValueError(f"{key} {tuple(shape)}: spec {spec.dims} has more dims than the tensor")
    out = []
    for dim, entry in enumerate(spec.dims + (None,) * (len(shape) - len(spec.dims))):
        if entry is None:
            out.append(None)
            continue
        cut = entry if isinstance(entry, Cut) else Cut(entry)
        n = sizes.get(cut.axis, 1)
        parts = _part_sizes(cut.parts, shape, dim)
        heads = cut.heads(key) if callable(cut.heads) else cut.heads
        split = n > 1 and all(p % n == 0 for p in parts) and (heads is None or heads % n == 0)
        out.append((cut.axis, parts) if split else None)
    return out


def _stack_lengths(keys) -> dict:
    lengths = collections.Counter()
    for key in keys:
        s = stack_of(key)
        if s is not None:
            lengths[s[0]] = max(lengths[s[0]], s[1] + 1)
    return lengths


def _owner(key, spec: Spec, sizes: dict, lengths: dict) -> Optional[int]:
    """The index along the layer axis of the rank that holds this block's
    tensor, or None where every rank holds it (no layer axis, or one that
    does not divide the list's length)."""
    if spec is None or spec.layers is None:
        return None
    stack, index = stack_of(key)
    d, n = sizes.get(spec.layers, 1), lengths[stack]
    if d == 1 or n % d:
        return None
    return index // (n // d)


def tp_param_shardings(mesh, state_shapes: dict, rules) -> dict:
    """This rank's index of every tensor of a state dict (a meta-device
    module's state_dict will do: nothing is placed) under `rules`: per dim
    a slice, or a tuple of slices (one a part) where a fused dim is cut per
    part; None for a block's tensor that a layer axis gives another rank."""
    sizes, indices = _sizes(mesh), _indices(mesh)
    lengths = _stack_lengths(state_shapes)
    specs = _specs(state_shapes, rules)
    out = {}
    for key, t in state_shapes.items():
        shape = tuple(t.shape)
        spec = specs[key]
        owner = _owner(key, spec, sizes, lengths)
        if owner is not None and owner != indices[spec.layers]:
            out[key] = None
            continue
        index = []
        cuts = _cuts(key, shape, spec, sizes) if spec is not None else [None] * len(shape)
        for cut in cuts:
            if cut is None:
                index.append(slice(None))
                continue
            axis, parts = cut
            n, r = sizes[axis], indices[axis]
            pieces, offset = [], 0
            for p in parts:
                pieces.append(slice(offset + r * (p // n), offset + (r + 1) * (p // n)))
                offset += p
            index.append(pieces[0] if len(pieces) == 1 else tuple(pieces))
        out[key] = tuple(index)
    return out


def _take(t: torch.Tensor, index: tuple) -> torch.Tensor:
    for dim, sel in enumerate(index):
        if isinstance(sel, tuple):
            t = torch.cat([t[(slice(None),) * dim + (s,)] for s in sel], dim=dim)
        elif sel != slice(None):
            t = t[(slice(None),) * dim + (sel,)]
    return t


def shard_params_tp(mesh, state_dict: dict, rules) -> dict:
    """This rank's shard of a full state dict under `rules` (Megatron-style
    tensor, expert and layer-axis sharding): views of `state_dict`'s
    tensors where a dim is cut in one block, a copy of the rank's parts
    only where a fused dim is cut per part; a block's tensors that a layer
    axis gives another rank are left out."""
    index = tp_param_shardings(mesh, state_dict, rules)
    return {k: _take(t, index[k]) for k, t in state_dict.items() if index[k] is not None}


def tp_plan_bytes(state_shapes, rules, axis_sizes: dict, dtype_bytes: int = 2) -> int:
    """Bytes per device under `rules`, from a state dict of shapes (a
    meta-device module's state_dict works: no weights are made): what one
    rank holds, its cut of every tensor and, under a layer axis, its blocks
    only.  `axis_sizes` maps axis names to sizes, e.g. {"tensor": 4}."""
    lengths = _stack_lengths(state_shapes)
    specs = _specs(state_shapes, rules)
    total = 0
    for key, t in state_shapes.items():
        shape = list(t.shape)
        spec = specs[key]
        if spec is None:
            total += math.prod(shape) * dtype_bytes
            continue
        if _owner(key, spec, axis_sizes, lengths) not in (None, 0):
            continue  # rank 0's blocks stand for every rank's
        for dim, cut in enumerate(_cuts(key, shape, spec, axis_sizes)):
            if cut is not None:
                shape[dim] //= axis_sizes[cut[0]]
        total += math.prod(shape) * dtype_bytes
    return total


def layer_shard_rules(rules, pred=None, axis: str = "data"):
    """FSDP-style layer-axis sharding composed with `rules`, as the JAX
    package's: a tensor of a block list (`pred`, default: `stack_of(key)`)
    keeps its rule's within-layer cuts and its list is depth-sharded over
    `axis`, a rank holding a contiguous 1/size of the blocks (all of them
    where the size does not divide the list's length); block tensors no
    rule cuts are depth-sharded alone; other tensors fall through to
    `rules`.  Before a block runs, its owner broadcasts the block's weights
    over `axis` (models/layers.py `LayerShards`)."""
    if pred is None:
        pred = lambda k: stack_of(k) is not None  # noqa: E731

    def layered(spec):
        spec = spec if isinstance(spec, Spec) else Spec(tuple(spec))
        return dataclasses.replace(spec, layers=axis)

    out = [(lambda k, p=p: p(k) and pred(k), layered(spec)) for p, spec in rules]
    out.append((pred, Spec(layers=axis)))
    out.extend(rules)
    return out


def _any(*fragments):
    return lambda k: any(f in k for f in fragments)


# -- Wan (models/wan.py)

_WAN_COL = tuple(f"{a}.{w}." for a in ("self_attn", "cross_attn") for w in "qkv") + ("ffn_0.",)
_WAN_ROW = ("self_attn.o.weight", "cross_attn.o.weight", "ffn_2.weight")


def wan_tp_rules(axis: str = "tensor"):
    """TP rules for the Wan DiT, the JAX package's: q/k/v and ffn_0 weights
    column-parallel (dim 0), o and ffn_2 weights row-parallel (dim 1);
    biases and norm scales replicated."""
    if axis is None:
        return []
    col = Spec((Cut(axis),), scanned=True)
    row = Spec((None, Cut(axis)), scanned=True)
    return [(_any(*(f + "weight" for f in _WAN_COL)), col), (_any(*_WAN_ROW), row)]


def wan_layout_rules(axis: str = "tensor"):
    """The shards `WanModel(cfg with tp_size > 1)` holds (the JAX package's
    shard_map layout, `wan_tp_param_specs`; `zoo.build_wan(mesh=...)` cuts
    with them): `wan_tp_rules` with the column-parallel biases and the
    full-width norm_q / norm_k scales cut with their weights."""
    if axis is None:
        return []
    col = Spec((Cut(axis),), scanned=True)
    return [(_any(*_WAN_COL, ".norm_q.", ".norm_k."), col)] + wan_tp_rules(axis)[1:]


def wan_tp_param_specs(state_dict: dict, rank: int, size: int) -> dict:
    """Tensor rank `rank`'s shard (of `size`) of a full Wan state dict, for
    `WanModel(cfg with tp_size=size)`: the column-parallel q/k/v and ffn_0
    weights and biases and the norm_q / norm_k scales cut on dim 0, the
    row-parallel o and ffn_2 weights on dim 1 (their biases, added once
    after the reduce, replicated), everything else whole.  The shards are
    views of `state_dict`'s tensors."""
    return shard_params_tp(plan_mesh(tensor=(size, rank)), state_dict, wan_layout_rules())


# -- the SD / SDXL UNet (models/unet.py)


def _unet_heads(cfg):
    """The head count of the spatial transformer a UNet key belongs to."""
    mults = cfg.channel_mult

    def heads(key):
        top = key.split(".", 1)[0]
        level = len(mults) - 1 if top == "mid_attn" else int(top.split("_")[1])
        ch = cfg.model_channels * mults[level]
        return ch // cfg.head_dim if cfg.head_dim is not None else cfg.num_heads

    return heads


def unet_tp_rules(cfg=None, axis: str = "tensor"):
    """TP rules for the SD / SDXL UNet, the JAX package's choices: the
    spatial transformers' blocks Megatron column / row (attn1's fused
    to_qkv and the hoisted cross k|v stack `kv_cross` (depth, ctx, 2c) cut
    per part, attn2's to_q column, both to_out row, the GEGLU in-projection
    and its bias column per part (a | gate), net_2 row), proj_in column
    with its bias, proj_out row; convolutions, GroupNorm and the time
    embedding replicated.  With `cfg` (a UNetConfig), a transformer whose
    head count the axis does not divide stays whole."""
    if axis is None:
        return []
    heads = None if cfg is None else _unet_heads(cfg)
    col = lambda parts=1: Cut(axis, parts, heads)  # noqa: E731
    blk = lambda k: stack_of(k) is not None  # noqa: E731
    return [
        (lambda k: blk(k) and "attn1.to_qkv.weight" in k, Spec((col(3),), scanned=True)),
        (lambda k: k.endswith(".kv_cross"), Spec((None, None, col(2)))),
        (lambda k: blk(k) and any(f"{a}.{w}.weight" in k for a in ("attn1", "attn2")
                                  for w in ("to_q", "to_k", "to_v")),
         Spec((col(),), scanned=True)),
        (lambda k: blk(k) and "to_out.weight" in k, Spec((None, col()), scanned=True)),
        (lambda k: blk(k) and "ff.net_0.proj.weight" in k, Spec((col(2),), scanned=True)),
        (lambda k: blk(k) and "ff.net_0.proj.bias" in k, Spec((col(2),), scanned=True)),
        (lambda k: blk(k) and "ff.net_2.weight" in k, Spec((None, col()), scanned=True)),
        (lambda k: "_attn.proj_in." in k, Spec((col(),))),
        (lambda k: "_attn.proj_out.weight" in k, Spec((None, col()))),
    ]


# -- the MMDiT: Flux, Qwen-Image (models/dit.py)


def _linear1_parts(shape):
    h = shape[1]  # (3h + mlp_h, h): q | k | v | mlp
    return h, h, h, shape[0] - 3 * h


def _linear2_parts(shape):
    h = shape[0]  # (h, h + mlp_h): attention | mlp
    return h, shape[1] - h


def dit_tp_rules(cfg=None, axis: str = "tensor"):
    """TP rules for the MMDiT family (Flux, Qwen-Image), the JAX package's
    choices: the double blocks' img / txt `attn_qkv` (q | k | v) and
    `mlp_0` column, `attn_proj` and `mlp_2` row; the single blocks'
    `linear1` column per part (q | k | v | mlp) and `linear2` row per part
    (attention | mlp); biases replicated (a column-parallel layer takes its
    slice of the bias), modulation whole.  With `cfg` (a DiTConfig), the
    blocks stay whole where the axis does not divide the head count.  The
    JAX package's rules also name Z-Image, where they match the 2-D
    `t_mlp_0` / `t_mlp_2` weights with a spec for scanned weights: so do
    these, and they raise ValueError there."""
    if axis is None:
        return []
    heads = None if cfg is None else cfg.num_heads
    col = lambda parts=1: Spec((Cut(axis, parts, heads),), scanned=True)  # noqa: E731
    row = lambda parts=1: Spec((None, Cut(axis, parts, heads)), scanned=True)  # noqa: E731
    return [
        (_any("attn_qkv.weight"), col(3)),
        (_any("linear1.weight"), col(_linear1_parts)),
        (_any("attn_proj.weight"), row()),
        (_any("linear2.weight"), row(_linear2_parts)),
        (_any("mlp_0.weight"), col()),
        (_any("mlp_2.weight"), row()),
    ]


# -- SD3 / SD3.5 (models/sd3.py)


def sd3_tp_rules(cfg=None, axis: str = "tensor"):
    """TP rules for the SD3 / SD3.5 MMDiT, the JAX package's choices:
    `qkv` (q | k | v, the dual attention's too) and `mlp_fc1` column,
    `attn_proj`, `attn2_proj` and `mlp_fc2` row, in the joint blocks and in
    the unstacked `joint_last` alike; biases replicated.  With `cfg` (an
    SD3Config), the blocks stay whole where the axis does not divide the
    head count."""
    if axis is None:
        return []
    heads = None if cfg is None else cfg.num_heads
    blk = lambda k: stack_of(k) is not None  # noqa: E731
    last = lambda k: k.startswith("joint_last.")  # noqa: E731
    col_in = _any("attn.qkv.weight", "attn2.qkv.weight", "mlp_fc1.weight")
    row_in = _any("attn_proj.weight", "attn2_proj.weight", "mlp_fc2.weight")

    def col(parts, scanned):
        return Spec((Cut(axis, parts, heads),), scanned=scanned)

    def row(scanned):
        return Spec((None, Cut(axis, 1, heads)), scanned=scanned)

    return [
        (lambda k: blk(k) and "qkv.weight" in k and col_in(k), col(3, True)),
        (lambda k: blk(k) and col_in(k), col(1, True)),
        (lambda k: blk(k) and row_in(k), row(True)),
        (lambda k: last(k) and "attn.qkv.weight" in k, col(3, False)),
        (lambda k: last(k) and "mlp_fc1.weight" in k, col(1, False)),
        (lambda k: last(k) and _any("attn_proj.weight", "mlp_fc2.weight")(k), row(False)),
    ]


# -- HiDream-I1 (models/hidream.py)


def hidream_ep_rules(cfg=None, axis: str = "tensor", expert_axis: str = "expert"):
    """EP x TP rules for the HiDream MoE-MMDiT, the JAX package's choices:
    the routed experts' stacks `experts_w1` / `experts_w3` (E, h, inner)
    cut to (E / expert, h, inner / tensor) and `experts_w2` (E, inner, h)
    likewise, so a rank computes its experts' slice and the gate's
    contraction ends in a sum over "expert" and "tensor"; the shared expert
    and the text SwiGLU (w1 / w3 column, w2 row) and the attention (to_q /
    to_k / to_v and the _t ones column, to_out and to_out_t row) Megatron;
    the router, the norms and the modulation whole.  With `cfg` (a
    HiDreamConfig), the tensor cut leaves a block whole where the axis does
    not divide the head count.  An axis given as None cuts nothing."""
    heads = None if cfg is None else cfg.num_heads
    t = None if axis is None else Cut(axis, 1, heads)
    experts = [(_any(".experts_w1", ".experts_w3"), Spec((expert_axis, None, t), scanned=True)),
               (_any(".experts_w2"), Spec((expert_axis, t, None), scanned=True))]
    if t is None:
        return experts if expert_axis is not None else []
    return experts + [
        (_any(".w1.weight", ".w3.weight"), Spec((t,), scanned=True)),
        (_any(".w2.weight"), Spec((None, t), scanned=True)),
        (_any(*(f".to_{w}{sfx}.weight" for w in "qkv" for sfx in ("", "_t"))),
         Spec((t,), scanned=True)),
        (_any(".to_out.weight", ".to_out_t.weight"), Spec((None, t), scanned=True)),
    ]


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
    "data" does not divide runs whole on every rank.  On the card the fused
    think-step kernels key their normals by the element's index in the
    whole batch (the engine passes rows.start * M as their offset), so they
    draw the one-process stream too.  The think loop's semantic stop reads
    batch-wide statistics that a rank sees only for its rows: a sampler
    whose config turns it on is refused."""
    config = getattr(sampler_call, "config", None)
    if config is not None and config.semantic_stop_possible:
        raise ValueError("with_data_parallel: the semantic stop reads the whole batch; "
                         "a rank sees only its rows (set inner_threshold=0)")
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
