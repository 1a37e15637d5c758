"""Weight bridge: the JAX package's flax UNet, MMDiT, Wan, VAE, Wan VAE and
TAESD parameter trees -> this package's module state_dicts.

The tree holds numpy arrays (e.g. `lanpaint_tpu.models.zoo.init_params_host`
output or `jax.device_get` of device params); nothing here imports JAX.
The mapping, the same for every family:

* dense kernels are (in, out); a torch Linear weight is (out, in);
* conv kernels are HWIO (2D) or DHWIO (3D); torch wants OIHW / OIDHW;
* `nn.scan` stacks every scanned block's parameters along a leading depth
  axis under `<stack>/block/...` (the UNet's `<transformer>/blocks/block`,
  the MMDiT's `double/block` and `single/block`, the Wan DiT's
  `blocks/block`, its per-block `modulation` included); they are unstacked
  into `<stack>.<i>....`;
* norm `scale` becomes `weight`; the GroupNorm32 wrapper's inner
  `GroupNorm_0` level disappears;
* the fused `to_qkv` (c, 3c) kernel keeps its q|k|v column order, and the
  stacked `kv_cross` (depth, context_dim, 2c) parameter is taken as is, as
  are every other leaf the rule above does not name (the Wan VAE's RMS
  `gamma`, the Wan DiT's `modulation` and `head_modulation`).
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


def _entry(path, arr):
    """(state_dict key, numpy view in torch's layout) of one flax leaf."""
    *mods, leaf = path
    if mods and mods[-1].startswith("GroupNorm_"):
        mods = mods[:-1]
    if leaf == "kernel":
        if arr.ndim == 5:
            arr = np.transpose(arr, (4, 3, 0, 1, 2))  # DHWIO -> OIDHW
        elif arr.ndim == 4:
            arr = np.transpose(arr, (3, 2, 0, 1))  # HWIO -> OIHW
        elif arr.ndim == 2:
            arr = arr.T
        else:
            raise ValueError(f"unexpected kernel rank {arr.ndim} at {'/'.join(path)}")
        leaf = "weight"
    elif leaf == "scale":
        leaf = "weight"
    return ".".join([*mods, leaf]), arr


def flax_entries(tree):
    """Yield (state_dict key, array) for every parameter of a flax tree
    ({"params": {...}} or the inner dict), scanned stacks unstacked.  The
    arrays are views of the tree's (no copy), so a tree of zero-stride
    arrays maps a full-size model's keys and shapes without allocating."""
    params = tree["params"] if "params" in tree else tree
    for path, arr in _flatten(params):
        arr = np.asarray(arr)
        if "block" in path[:-1]:
            j = path.index("block")
            for depth in range(arr.shape[0]):
                yield _entry(path[:j] + (str(depth),) + path[j + 1:], arr[depth])
        else:
            yield _entry(path, arr)


def params_from_flax(tree) -> dict:
    """Map a flax UNet, MMDiT, Wan, VAE or Wan VAE parameter tree onto the
    port module's `state_dict()` keys, as torch tensors."""
    return {key: _to_tensor(arr) for key, arr in flax_entries(tree)}


unet_params_from_flax = dit_params_from_flax = wan_params_from_flax = params_from_flax
vae_params_from_flax = wan_vae_params_from_flax = params_from_flax
