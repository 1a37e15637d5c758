"""Weight bridge: the JAX package's flax UNet, ControlNet, MMDiT, SD3, HiDream,
HunyuanVideo, Z-Image, Wan, VAE, Wan VAE, TAESD, CLIP, T5, Llama and
Qwen2.5-VL vision parameter trees -> this package's module state_dicts
(and a two-model wrapper's pair of trees, or the ControlNet-conditioned
UNet's {"unet", "cn"}, -> its nn.ModuleDict's, `pair_params_from_flax`).

The tree holds numpy arrays (e.g. `lanpaint_tpu.models.zoo.init_params_host`
output or `jax.device_get` of device params); nothing here imports JAX.
The mapping, the same for every family:

* dense kernels are (in, out); a torch Linear weight is (out, in);
* conv kernels are HWIO (2D) or DHWIO (3D); torch wants OIHW / OIDHW;
* `nn.scan` stacks every scanned block's parameters along a leading depth
  axis under `<stack>/block/...` (the UNet's `<transformer>/blocks/block`,
  the MMDiT's, HiDream's and HunyuanVideo's `double/block` and
  `single/block`, SD3's `joint_dual/block` and `joint/block`,
  HunyuanVideo's `txt_in/refiner/block`, the Wan DiT's `blocks/block`,
  its per-block `modulation` included), or, in the text
  encoders, directly under a top-level `layers/...` (CLIP) or `blocks/...`
  (T5, its per-layer relative-bias tables included); they are unstacked
  into `<stack>.<i>....`;
* norm `scale` becomes `weight`; the GroupNorm32 wrapper's inner
  `GroupNorm_0` level disappears;
* the fused `to_qkv` (c, 3c) kernel keeps its q|k|v column order, and the
  stacked `kv_cross` (depth, context_dim, 2c) parameter is taken as is, as
  are every other leaf the rule above does not name (the Wan VAE's RMS
  `gamma`, the Wan DiT's `modulation` and `head_modulation`, CLIP's
  `text_projection` (width, projection_dim), used as `x @ proj`, and its
  embedding tables, T5's `shared` and `rel_bias`, Llama's top-level
  `embed_tokens`, the vision tower's raw RMS scales `norm1`, `norm2` and
  `ln_q`, SD3's learned `pos_embed`, HiDream's stacked caption
  projections `cap_proj_double` / `cap_proj_single` (depth, llama_dim,
  hidden) and MoE experts `experts_w1/w2/w3` (E, in, out), all used as
  `x @ w`).

`state_key`, `module_layout` and `flax_layout` are the same rule for one
leaf, on numpy arrays or torch tensors; `models/load.py` maps checkpoints
through them.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, dict) or hasattr(val, "items"):
            yield from _flatten(val, path)
        else:
            yield path, val


def _to_tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr).copy())


def _transpose(arr, axes):
    if isinstance(arr, torch.Tensor):
        return arr.permute(*axes)
    return np.transpose(arr, axes)


# a flax kernel's axes -> torch's, by rank: DHWIO -> OIDHW, HWIO -> OIHW, (in, out) -> (out, in)
_KERNEL_AXES = {5: (4, 3, 0, 1, 2), 4: (3, 2, 0, 1), 2: (1, 0)}
_WEIGHT_AXES = {5: (2, 3, 4, 1, 0), 4: (2, 3, 1, 0), 2: (1, 0)}


def state_key(path) -> str:
    """The state_dict key of an unstacked flax leaf path."""
    *mods, leaf = path
    if mods and mods[-1].startswith("GroupNorm_"):
        mods = mods[:-1]
    if leaf in ("kernel", "scale"):
        leaf = "weight"
    return ".".join([*mods, leaf])


def module_layout(path, arr):
    """A flax leaf's value in the module's layout (a view, no copy)."""
    if path[-1] != "kernel":
        return arr
    if arr.ndim not in _KERNEL_AXES:
        raise ValueError(f"unexpected kernel rank {arr.ndim} at {'/'.join(path)}")
    return _transpose(arr, _KERNEL_AXES[arr.ndim])


def flax_layout(path, arr):
    """The inverse of `module_layout`: a module parameter in flax's layout."""
    if path[-1] != "kernel":
        return arr
    return _transpose(arr, _WEIGHT_AXES[arr.ndim])


def is_stacked(path) -> bool:
    """Whether a flax leaf path lies in a scanned stack (leading depth axis)."""
    return "block" in path[:-1] or (
        len(path) >= 2 and path[0] in ("layers", "blocks") and path[1] != "block")


def unstack(path, depth: int):
    """The path of depth `depth` of a stacked leaf: the index takes the
    place of the scan's `block` level, or follows the text encoders'
    top-level `layers` / `blocks`."""
    if "block" in path[:-1]:
        j = path.index("block")
        return path[:j] + (str(depth),) + path[j + 1:]
    return path[:1] + (str(depth),) + path[1:]


def _entry(path, arr):
    """(state_dict key, view in torch's layout) of one unstacked flax leaf."""
    return state_key(path), module_layout(path, arr)


def flax_entries(tree):
    """Yield (state_dict key, array) for every parameter of a flax tree
    ({"params": {...}} or the inner dict), scanned stacks unstacked.  The
    arrays are views of the tree's (no copy), so a tree of zero-stride
    arrays maps a full-size model's keys and shapes without allocating."""
    params = tree["params"] if "params" in tree else tree
    for path, arr in _flatten(params):
        arr = np.asarray(arr)
        if is_stacked(path):
            for depth in range(arr.shape[0]):
                yield _entry(unstack(path, depth), arr[depth])
        else:
            yield _entry(path, arr)


def params_from_flax(tree) -> dict:
    """Map a flax UNet, ControlNet, MMDiT, SD3, HiDream, HunyuanVideo,
    Z-Image, Wan, VAE, Wan VAE, CLIP, T5, Llama or vision-tower parameter
    tree onto the port module's `state_dict()` keys, as torch tensors."""
    return {key: _to_tensor(arr) for key, arr in flax_entries(tree)}


unet_params_from_flax = dit_params_from_flax = wan_params_from_flax = params_from_flax
controlnet_params_from_flax = params_from_flax
vae_params_from_flax = wan_vae_params_from_flax = params_from_flax
zimage_params_from_flax = llama_params_from_flax = vision_params_from_flax = params_from_flax
sd3_params_from_flax = hidream_params_from_flax = hyvideo_params_from_flax = params_from_flax


def pair_params_from_flax(trees) -> dict:
    """Map a JAX two-model wrapper's parameters, {"high": tree, "low": tree}
    (`zoo.switching_denoiser`), {"pos": tree, "neg": tree}
    (`zoo.dual_model_denoiser`) or {"unet": tree, "cn": tree}
    (`zoo.build_controlled_unet`), onto the port wrapper's `module`
    (nn.ModuleDict) state_dict keys, each tree through `params_from_flax`."""
    return {f"{name}.{key}": val for name, tree in trees.items()
            for key, val in params_from_flax(tree).items()}
