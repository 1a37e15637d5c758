"""Weight bridge: the JAX package's flax UNet parameter tree -> this
package's UNetModel state_dict.

The tree holds numpy arrays (e.g. `lanpaint_tpu.models.zoo.init_params_host`
output or `jax.device_get` of device params); nothing here imports JAX.
The mapping:

* dense kernels are (in, out); a torch Linear weight is (out, in);
* conv kernels are HWIO; torch wants OIHW;
* `nn.scan` stacks every BasicTransformerBlock parameter along a leading
  depth axis under `<stack>/blocks/block/...`; it is unstacked into
  `<stack>.blocks.<i>....`;
* norm `scale` becomes `weight`; the GroupNorm32 wrapper's inner
  `GroupNorm_0` level disappears;
* the fused `to_qkv` (c, 3c) kernel keeps its q|k|v column order, and the
  stacked `kv_cross` (depth, context_dim, 2c) parameter is taken as is.
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


def _put(state: dict, path, arr) -> None:
    *mods, leaf = path
    if mods and mods[-1].startswith("GroupNorm_"):
        mods = mods[:-1]
    if leaf == "kernel":
        if arr.ndim == 4:
            arr = np.transpose(arr, (3, 2, 0, 1))  # HWIO -> OIHW
        elif arr.ndim == 2:
            arr = arr.T
        else:
            raise ValueError(f"unexpected kernel rank {arr.ndim} at {'/'.join(path)}")
        leaf = "weight"
    elif leaf == "scale":
        leaf = "weight"
    state[".".join([*mods, leaf])] = _to_tensor(arr)


def unet_params_from_flax(tree) -> dict:
    """Map a flax UNet parameter tree ({"params": {...}} or the inner dict)
    onto `UNetModel.state_dict()` keys."""
    params = tree["params"] if "params" in tree else tree
    state: dict = {}
    for path, arr in _flatten(params):
        arr = np.asarray(arr)
        if "blocks" in path and path[path.index("blocks") + 1] == "block":
            j = path.index("blocks")
            for depth in range(arr.shape[0]):
                _put(state, path[:j] + ("blocks", str(depth)) + path[j + 2:], arr[depth])
        else:
            _put(state, path, arr)
    return state
