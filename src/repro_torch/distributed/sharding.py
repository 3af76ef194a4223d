"""Divisibility-aware sharding rules (DESIGN.md §6), over the port's own
parameter and cache trees (port of `repro.distributed.sharding`).

Rules map parameter and cache leaves to specs:

  train  — FSDP on "data" (weight matrices sharded on their non-TP dim),
           tensor parallel on "model", "pod" = extra data parallelism.
  serve  — tensor parallel on "model"; experts expert-parallel on "data"
           when the expert count divides it; batch ("pod", "data") on
           activations and KV caches.

A dim is sharded on an axis only when divisible — otherwise the rule
degrades to replication on that axis (e.g. qwen1.5-4b's 20 heads,
whisper's 12 heads, qwen2-moe's 60 experts). Head-count nondivisibility
is recovered where the *flattened* projection dim divides the axis.

A spec is a tuple with one entry per dim of its leaf: an axis name, a
tuple of names (the dim split over several mesh axes, major first) or
None (replicated): what a JAX `PartitionSpec` holds. A mesh is anything
with `axis_names` and a `shape` mapping (a structural stand-in), or a
torch `DeviceMesh` (`mesh_dim_names`, `size(i)`). Leaf shapes come from
the port's `init_params` / `init_cache` on the meta device, so no rule
allocates memory or needs a card. The port keeps one dict per layer
where the reference stacks a stage's layers on a leading axis, so a
reference spec on a stacked leaf is the port's with its leading None
dropped.

`to_placements` turns a spec into DTensor placements on a DeviceMesh and
`distribute` places a tree leaf by leaf (the counterpart of the
reference's `to_named`). Nothing here touches a process group until
`distribute` is called.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.launch.mesh import mesh_axes
from repro_torch.models import model as M

Spec = tuple


def _div(size: int, axes: dict, axis: Optional[str]):
    """axis if it divides size else None."""
    if axis is None or axis not in axes:
        return None
    return axis if size % axes[axis] == 0 else None


def _axes_size(axes: dict, names) -> int:
    if names is None:
        return 1
    if isinstance(names, str):
        names = (names,)
    n = 1
    for a in names:
        n *= axes[a]
    return n


def _entry(e):
    """An entry as `PartitionSpec` normalises it: a tuple of one axis is
    that axis, an empty one None."""
    if isinstance(e, tuple) and len(e) <= 1:
        return e[0] if e else None
    return e


def _pad(spec, ndim: int) -> Spec:
    """A spec with one entry per dim (trailing dims replicated)."""
    return tuple(map(_entry, spec)) + (None,) * (ndim - len(spec))


def _leaf_spec(name: str, shape, axes: dict, mode: str, moe_axis: str,
               cfg: ModelConfig, head_align: bool) -> Spec:
    """Spec of one parameter leaf of the port's per-layer tree."""
    fsdp = "data" if mode == "train" else None
    tp = "model"

    def d(i, axis):  # shard dim i on axis if divisible
        return _div(shape[i], axes, axis)

    def d_heads(i, axis, n_heads):
        """shard dim i only when whole heads land on each shard — slicing a
        head across shards makes every score einsum a partial-sum
        all-reduce of the full (B,T,H,S) tensor (§Perf H-align)."""
        if head_align and axis in axes and n_heads % axes[axis] != 0:
            return None
        return d(i, axis)

    if name == "embed":
        return (d(0, tp), d(1, fsdp))
    if name == "head":
        return (d(0, fsdp), d(1, tp))
    if name == "pos":
        return (None, None)
    if name == "wq":
        return (d(0, fsdp), d_heads(1, tp, cfg.n_heads))
    if name in ("wk", "wv"):
        return (d(0, fsdp), d_heads(1, tp, cfg.n_kv_heads))
    if name == "wo":
        return (d_heads(0, tp, cfg.n_heads), d(1, fsdp))
    if name in ("wg", "wu", "wi"):
        return (d(0, fsdp), d(1, tp))
    if name == "wd":
        return (d(0, tp), d(1, fsdp))
    if name == "router":
        return (d(0, fsdp), None)
    if name in ("w_gate", "w_up"):
        if moe_axis == "model":
            # expert parallelism on the TP axis: tokens are replicated
            # across "model", so each shard runs its local experts and the
            # combine is a small all-reduce (§Perf H2)
            return (d(0, "model"), d(1, fsdp), None)
        ep = d(0, "data")
        return (ep, d(1, fsdp) if ep is None else None, d(2, tp))
    if name == "w_down":
        if moe_axis == "model":
            return (d(0, "model"), None, d(2, fsdp))
        ep = d(0, "data")
        return (ep, d(1, tp), d(2, fsdp) if ep is None else None)
    # --- MLA ---
    if name in ("wdq", "wdkv", "wkr"):
        return (d(0, fsdp), None)
    if name in ("wuq", "wuk", "wuv"):
        return (d(0, fsdp), d(1, tp))
    # --- SSM (baseline: FSDP only; TP for SSD is a hillclimb lever) ---
    if name == "in_proj":
        return (d(0, fsdp), None)
    if name == "out_proj":
        return (None, d(1, fsdp))
    if name == "proj":  # mtp projection
        return (d(0, fsdp), d(1, tp))
    # everything else (norms, biases, conv, A_log, dt_bias, ...): replicate
    return ()


def map_with_path(fn, tree, path=()):
    """`fn(path, leaf)` over a tree of dicts, lists and tuples; a path
    holds the keys on the way (list positions as ints)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


@functools.lru_cache(maxsize=16)
def param_shapes(cfg: ModelConfig):
    """The port's `init_params(cfg)` tree on the meta device (shapes and
    dtypes, no memory)."""
    return M.init_params(cfg, device="meta")


def param_specs(cfg: ModelConfig, mesh, mode: str = "train",
                moe_axis: str = "data", head_align: bool = False):
    """Tree of specs matching the port's `init_params(cfg)` structure."""
    axes = mesh_axes(mesh)

    def spec(path, leaf):
        name = [k for k in path if isinstance(k, str)][-1]
        return _pad(_leaf_spec(name, leaf.shape, axes, mode, moe_axis, cfg,
                               head_align), leaf.dim())

    return map_with_path(spec, param_shapes(cfg))


# ---------------------------------------------------------------- caches

def _cache_leaf_spec(name: str, shape, axes: dict, batch_axes,
                     kv_shard: str = "auto") -> Spec:
    """Spec of one leaf of a layer's cache, (B, ...)."""
    bax = batch_axes if shape[0] % _axes_size(axes, batch_axes) == 0 \
        else None
    seq = kv_shard == "seq" and len(shape) > 1 \
        and _div(shape[1], axes, "model")
    if name in ("k", "v"):
        hkv, hd = shape[2], shape[3]
        if seq:
            # sequence-parallel KV (flash-decoding partial merge — §Perf)
            return (bax, "model", None, None)
        # (B, C, Hkv, D): heads on model if divisible, else head_dim
        if _div(hkv, axes, "model"):
            return (bax, None, "model", None)
        if _div(hd, axes, "model"):
            return (bax, None, None, "model")
        return (bax, None, None, None)
    if name in ("k_scale", "v_scale"):
        if seq:
            return (bax, "model", None)
        if _div(shape[2], axes, "model"):
            return (bax, None, "model")
        return (bax, None, None)
    if name == "slot_pos":
        return (bax, "model") if seq else (bax, None)
    if name == "ssm":
        return (bax, _div(shape[1], axes, "model"), None, None)
    if name == "conv":
        return (bax, None, None)
    if name == "pos":
        return (bax,)
    return ()


def cache_specs(cfg: ModelConfig, mesh, batch: int, max_len: int,
                dtype=torch.bfloat16, kv_shard: str = "auto"):
    """(shapes, specs) for the decode cache of (cfg, batch, max_len): the
    port's `init_cache` tree on the meta device and its specs.
    kv_shard: "auto" (heads, then head_dim) | "seq" (capacity dim on
    "model" — pair with cfg.decode_attn == "parallel")."""
    shapes = M.init_cache(cfg, batch, max_len, dtype=torch_dtype(dtype),
                          device="meta")
    axes = mesh_axes(mesh)
    bax = batch_spec(mesh, batch)

    def spec(path, leaf):
        if path == ("lengths",):
            return _pad((bax if bax and leaf.shape[0]
                         % _axes_size(axes, bax) == 0 else None,), 1)
        return _pad(_cache_leaf_spec(path[-1], leaf.shape, axes, bax,
                                     kv_shard), leaf.dim())

    return shapes, map_with_path(spec, shapes)


def batch_spec(mesh, global_batch: int):
    """Axis tuple for the batch dim of activations/tokens."""
    axes = mesh_axes(mesh)
    bax = tuple(a for a in ("pod", "data") if a in axes)
    if global_batch % _axes_size(axes, bax) == 0:
        return bax
    if global_batch % axes["data"] == 0:
        return ("data",)
    return None


# ------------------------------------------------------------ placement

def to_placements(spec: Spec, device_mesh):
    """DTensor placements of `spec` on `device_mesh`: Shard(d) on each
    mesh dim that dim d of the leaf is split over, Replicate() on the
    others. A dim on an axis tuple (("pod", "data")) takes Shard(d) on
    each of those mesh dims, the first the major one, as JAX orders it."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(device_mesh.mesh_dim_names)
    placements = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry,) if isinstance(entry, str) else entry:
            placements[names.index(axis)] = Shard(d)
    return placements


def spec_at(specs, path) -> Spec:
    """The spec at `path` (a `map_with_path` path) of a spec tree."""
    for k in path:
        specs = specs[k]
    return specs


def distribute(tree, specs, device_mesh):
    """Each leaf of `tree` as a DTensor on `device_mesh`, placed by its
    spec in `specs` (a tree of the same structure): the counterpart of
    the reference's `to_named`. Needs the process group `device_mesh`
    was built on."""
    from torch.distributed.tensor import distribute_tensor

    def place(path, leaf):
        return distribute_tensor(
            leaf, device_mesh,
            to_placements(spec_at(specs, path), device_mesh))

    return map_with_path(place, tree)
