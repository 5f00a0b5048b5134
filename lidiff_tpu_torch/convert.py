"""Weight bridge: load a JAX `{"params", "batch_stats"}` tree into one of
the port's models (`DiffusionModel`, the refiner's `MinkUNet`), and map the
port's tensors back onto that tree.

The tree is given as nested dicts of numpy arrays (e.g. `jax.device_get`
of the JAX variables, or a checkpoint read with numpy), keyed by the flax
module names. The port's submodules carry the same names, so a flax path
`partial_enc/Stem_0/ConvBNReLU_0/SparseConv_0/kernel` is the torch key
`partial_enc.Stem_0.ConvBNReLU_0.SparseConv_0.kernel` (the refiner's tree
starts at `Stem_0/...` and ends with `head/Dense_1`), with two rules:
  * Dense kernels are [in, out] in flax and `weight` [out, in] in torch;
  * sparse conv kernels stay [taps, Cin, Cout].
BatchNorm `scale`/`bias` are parameters, `mean`/`var` buffers. A missing or
extra key, or a shape mismatch, raises. `state_dict_to_flax` is the inverse,
for any {torch key: tensor} mapping (a state dict, or the gradients by
parameter name), so that a state trained by the port can be read by the JAX
package and the tests can compare the two trees leaf by leaf.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def flax_to_state_dict(variables) -> dict[str, torch.Tensor]:
    """Map a flax variables tree to torch state-dict keys and layouts."""
    out = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})):
            arr = np.asarray(leaf, dtype=np.float32)
            parent, name = path[:-1], path[-1]
            if parent and parent[-1].startswith("Dense_") and name == "kernel":
                name, arr = "weight", arr.T
            out[".".join(parent + (name,))] = torch.from_numpy(
                np.ascontiguousarray(arr))
    return out


def load_jax_variables(model: nn.Module, variables) -> None:
    """Copy a JAX variables tree into `model` (in place, on its device)."""
    sd = flax_to_state_dict(variables)
    want = model.state_dict()
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    if missing or extra:
        raise KeyError(f"weight bridge: missing {missing[:8]} "
                       f"({len(missing)}), extra {extra[:8]} ({len(extra)})")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(f"weight bridge: {k} has shape "
                             f"{tuple(v.shape)}, want {tuple(want[k].shape)}")
    model.load_state_dict(sd, strict=True)


def state_dict_to_flax(tensors) -> dict:
    """Inverse of `flax_to_state_dict`: {torch key: tensor} to a
    `{"params", "batch_stats"}` tree of float32 numpy arrays in the flax
    names and layouts. BatchNorm `mean`/`var` go to `batch_stats`, all else
    to `params`."""
    out = {"params": {}, "batch_stats": {}}
    for key, t in tensors.items():
        *parent, name = key.split(".")
        arr = t.detach().cpu().float().numpy()
        if parent and parent[-1].startswith("Dense_") and name == "weight":
            name, arr = "kernel", arr.T
        is_stat = (parent and parent[-1].startswith("MaskedBatchNorm_")
                   and name in ("mean", "var"))
        node = out["batch_stats" if is_stat else "params"]
        for k in parent:
            node = node.setdefault(k, {})
        node[name] = np.ascontiguousarray(arr)
    return out
