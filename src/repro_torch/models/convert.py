"""Weight bridge: the reference's parameter tree <-> the port's.

The JAX package stacks the parameters of each stage of its layer plan
along a leading `reps` axis (its `lax.scan` layout):
  {"embed", "stages": [tuple(sublayer dict with leading reps)],
   "final_norm", "head"?}
`params_from_numpy` splits that axis into one dict per layer, in layer
order, and moves every leaf to a tensor on `device`; a MoE layer's FFN
comes across as its dict of `router` (d, E), `w_gate` / `w_up` (E, d, f),
`w_down` (E, f, d) and the `shared` expert's MLP; a cross layer's
`ln_cross` and `cross` come with its dict; an encoder-decoder's
`encoder` subtree ({"stage": (one stacked layer dict,), "final_norm",
"pos"}) becomes {"layers": [one dict per encoder layer], "final_norm",
"pos"}; DeepSeek-V3's `mtp` subtree (not stacked: {"proj", "norm_h",
"norm_e", "layer"}) comes across as it is. Quantized leaves
(``{"w8": int8, "scale": f32}`` of `repro.models.quantize`, the `reps`
axis on both) come across as the same dicts of tensors, so quantizing in
JAX and converting gives the bits of converting and quantizing with
`models.quantize.quantize_params`. The leaves must
already be numpy arrays (convert with `np.asarray` on the JAX side) or
CPU tensors (the checkpoint reader's), so this module needs neither JAX
nor the reference package.

`reference_tree` is the inverse: the port's per-layer dicts restacked
along each stage's `reps` axis into the reference's `init_params`
nesting (a list of stages, each a tuple of sublayer dicts; the encoder's
one-sublayer stage a tuple too), so a checkpoint's flat keys
(`stages/__L0/__T0/...`) are the reference's. `params_to_numpy` gives it
with numpy leaves.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import layer_plan


def _to_tensor(a, device):
    # a private, writable copy: the leaves may be read-only views of JAX
    # buffers or slices of a stacked checkpoint tensor, and the layers'
    # tensors must not share them
    if torch.is_tensor(a):
        return a.to(device, copy=True)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    return fn(x)


def _unstack(stage, reps, dev):
    """One dict per layer of a stage: (sublayer dicts with a leading
    `reps` axis) -> [layer dicts], repeat-major."""
    return [_tree(sub, lambda a, r=r: _to_tensor(a[r], dev))
            for r in range(reps) for sub in stage]


def params_from_numpy(tree, cfg: ModelConfig, device=None):
    """Port parameters from the reference's `init_params` tree (numpy
    leaves); the per-stage `reps` axis becomes per-layer tensors."""
    dev = resolve_device(device)
    layers = []
    for (_pattern, reps), stage in zip(layer_plan(cfg), tree["stages"]):
        layers += _unstack(stage, reps, dev)
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers in the tree, config has "
                         f"{cfg.n_layers}")
    def conv(a):
        return _to_tensor(a, dev)

    out = {"embed": _tree(tree["embed"], conv), "layers": layers}
    for key in ("final_norm", "head", "pos", "mtp"):
        if key in tree:
            out[key] = _tree(tree[key], conv)
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {
            "layers": _unstack(enc["stage"], cfg.encoder_layers, dev),
            "final_norm": _tree(enc["final_norm"], conv),
            "pos": conv(enc["pos"])}
    return out


def _stack(layers, dev):
    """One sublayer dict with a leading `reps` axis from the per-layer
    dicts of its repeats."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([lay[k] for lay in layers], dev) for k in first}
    return torch.stack([t.detach().to(dev) for t in layers])


def _restack(layers, pattern_len, reps, dev):
    """The inverse of `_unstack`: a stage's tuple of stacked sublayers."""
    return tuple(_stack(layers[j::pattern_len][:reps], dev)
                 for j in range(pattern_len))


def reference_tree(params, cfg: ModelConfig, device="cpu"):
    """The reference's `init_params` tree of the port's parameters, with
    tensor leaves on `device` (the checkpoint writer's layout)."""
    def conv(t):
        return t.detach().to(device)

    layers = params["layers"]
    stages, i = [], 0
    for pattern, reps in layer_plan(cfg):
        n = len(pattern) * reps
        stages.append(_restack(layers[i: i + n], len(pattern), reps, device))
        i += n
    if i != len(layers):
        raise ValueError(f"{len(layers)} layers in the params, the plan "
                         f"has {i}")
    out = {"embed": _tree(params["embed"], conv), "stages": stages}
    for key in ("final_norm", "head", "pos", "mtp"):
        if key in params:
            out[key] = _tree(params[key], conv)
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = {
            "stage": _restack(enc["layers"], 1, len(enc["layers"]), device),
            "final_norm": _tree(enc["final_norm"], conv),
            "pos": conv(enc["pos"])}
    return out


def params_to_numpy(params, cfg: ModelConfig):
    """The inverse of `params_from_numpy`: the reference's `init_params`
    tree with numpy leaves (float32, int8 and other numpy dtypes; a
    bfloat16 leaf has no numpy dtype here, see `reference_tree`)."""
    def to_numpy(x):
        if isinstance(x, dict):
            return {k: to_numpy(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(to_numpy(v) for v in x)
        return x.numpy()

    return to_numpy(reference_tree(params, cfg))
